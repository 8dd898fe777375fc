"""LR schedules: linear-warmup cosine, and WSD (warmup-stable-decay, the
MiniCPM schedule).  They take the step as a tensor and return an f32
tensor on its device: no host sync."""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup: int, total: int, min_frac: float = 0.1):
    step = _f32(step)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, warmup: int, total: int, decay_frac: float = 0.1,
        min_frac: float = 0.01):
    """Warmup-Stable-Decay: hold lr flat, then exponential-ish final decay."""
    step = _f32(step)
    decay_start = total * (1 - decay_frac)
    warm = step / max(warmup, 1)
    decay_prog = torch.clamp((step - decay_start)
                             / max(total - decay_start, 1), 0, 1)
    decay = min_frac ** decay_prog
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start, 1.0, decay))


def get_schedule(name: str):
    return {"cosine": warmup_cosine, "wsd": wsd}[name]
