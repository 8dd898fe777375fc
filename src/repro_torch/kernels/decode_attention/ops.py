"""Dense decode attention (kernel B1) at the model's layout.

A CPU tensor runs the plain version (`ref.decode_attention_reference`); a
CUDA tensor launches the CUDA kernel or raises.  Unlike the reference,
which picks the Pallas kernel through `attn_impl` and the
`REPRO_DECODE_ATTN` environment variable, the port has no switch: the
tensor's device decides.  `decode_attention.launches` counts the calls
that launch the kernels (each launches a split and a merge kernel).
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import decode_attention_reference


def kv_lens(kv_len, batch: int, device) -> torch.Tensor:
    """A scalar or (B,) length -> a contiguous (B,) int32 tensor on
    `device`, with no host round-trip for device tensors."""
    if torch.is_tensor(kv_len):
        return kv_len.to(device=device, dtype=torch.int32).reshape(-1) \
            .expand(batch).contiguous()
    return torch.full((batch,), int(kv_len), dtype=torch.int32,
                      device=device)


def decode_attention(q, k_cache, v_cache, kv_len):
    """q (B, 1, H, dh) or (B, H, dh); caches (B, M, Hkv, dh) model layout;
    kv_len a scalar or (B,).  Returns q's rank and dtype."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    lens = kv_lens(kv_len, q.shape[0], q.device)
    if q.device.type == "cpu":
        out = decode_attention_reference(q, k_cache, v_cache, lens)
    else:
        out = kernel.decode_attention_fwd(q, k_cache, v_cache, lens)
        decode_attention.launches += 1
    return out[:, None] if squeeze else out


decode_attention.launches = 0
