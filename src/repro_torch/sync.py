"""Host-sync guard shared by the serving engine's decode block and the
trainer's fused K-step block."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_host_sync(device):
    """On a CUDA device, an op that waits for the device raises inside
    this block (a CPU run has no device to wait for)."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
