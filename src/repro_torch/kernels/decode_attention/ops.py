"""Dense decode attention (kernel B1) at the model's layout.

A CPU tensor runs the plain version (`ref.decode_attention_reference`); a
CUDA tensor launches the CUDA kernel or raises.  Unlike the reference,
which picks the Pallas kernel through `attn_impl` and the
`REPRO_DECODE_ATTN` environment variable, the port has no switch: the
tensor's device decides.  `decode_attention.launches` counts the calls
that launch the kernels (each launches a split and a merge kernel).

A DTensor goes through `_boundary.heads_local_map` (each rank's rows and
heads; `kv_len` a scalar then); a fake tensor launches nothing and
reports the kernel's FLOPs and bytes over the whole cache
(`_boundary.COUNTS["decode_attention"]`: a fake cache has no lengths to
read).
"""
from __future__ import annotations

import torch

from .. import _boundary
from . import kernel
from .ref import decode_attention_reference


def fake_decode(name, q, k_cache, v_cache):
    """A fake call of B1 / B2: q (B, H, dh), caches of B * M positions in
    all (a pool's pages stand in for the rows' caches).  4 B H M dh
    FLOPs, the caches read once."""
    b, h, dh = q.shape
    m = k_cache.numel() // (k_cache.shape[-1] * k_cache.shape[-2] * b)
    out = _boundary.fake_like(q, q.shape)
    _boundary.report(name, 4 * b * h * m * dh,
                     _boundary.nbytes(q, k_cache, v_cache, out))
    return out


def _scalar_len(kv_len):
    """A DTensor call's kv_len as a plain scalar (a (B,) vector would have
    to be placed like the rows)."""
    if _boundary.is_dtensor(kv_len):
        kv_len = kv_len.to_local()
    if torch.is_tensor(kv_len) and kv_len.dim():
        raise ValueError("a sharded decode call takes a scalar kv_len")
    return kv_len


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
    if _boundary.is_dtensor(q):
        n = _scalar_len(kv_len)
        return _boundary.heads_local_map(
            lambda a, b, c: decode_attention(a, b, c, n), q, k_cache,
            v_cache, head_dim=q.dim() - 2)
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    if _boundary.is_fake(q):
        out = fake_decode("decode_attention", q, k_cache, v_cache)
        return out[:, None] if squeeze else out
    lens = kv_lens(kv_len, q.shape[0], q.device)
    if q.device.type == "cpu":
        out = decode_attention_reference(q, k_cache, v_cache, lens)
    else:
        out = kernel.decode_attention_fwd(q, k_cache, v_cache, lens)
        decode_attention.launches += 1
    return out[:, None] if squeeze else out


decode_attention.launches = 0
