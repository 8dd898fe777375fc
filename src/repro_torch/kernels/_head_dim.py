"""Head dims below the attention kernels' smallest instance.

The kernels (B1, B2, B3) have instances at dh 64 and up; the reduced
configs run at dh 8, 12, 16 and 20.  A wrapper zero-pads q, k and v (or
the cache or page pool) along dh to the 64 instance, passes the softmax
scale of the true dh, launches the kernel and slices the output back.
Zero columns add nothing to q.k, and the padded columns of v only give
output columns that are sliced away, so this is the same function, run by
the kernel: no fallback.
"""
from __future__ import annotations

import torch.nn.functional as F

PAD_TO = 64   # the smallest instance of every attention kernel


def instance_head_dim(dh: int, instances: tuple, kernel: str) -> int:
    """The head dim of the instance that runs a head dim of `dh`: dh itself
    where there is an instance, 64 for 0 < dh < 64 (zero-padded); raises
    ValueError otherwise."""
    if dh in instances:
        return dh
    if 0 < dh < PAD_TO:
        return PAD_TO
    raise ValueError(f"{kernel} kernel takes head_dim in {instances} (or "
                     f"below {PAD_TO}, zero-padded to {PAD_TO}), got {dh}")


def pad_head_dim(t, dh: int):
    """t zero-padded along its last dim to `dh` (t itself at dh)."""
    return t if t.shape[-1] == dh else F.pad(t, (0, dh - t.shape[-1]))
