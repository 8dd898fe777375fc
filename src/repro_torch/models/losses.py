"""LM losses: plain and sequence-chunked softmax cross-entropy.

`chunked_lm_loss` computes logits -> xent one sequence chunk at a time
under `torch.utils.checkpoint`, so the backward pass recomputes each
chunk's (B, chunk, V) logits instead of keeping the whole (B, S, V)
tensor alive: the counterpart of the reference's `jax.checkpoint` scan.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def softmax_xent(logits, labels):
    """Per-position cross-entropy, logsumexp(logits) - logits[label], in
    f32.  The gold logit is a gather, whose backward is deterministic on
    the card under `torch.use_deterministic_algorithms(True)`."""
    logits = logits.float()
    gold = logits.gather(-1, labels[..., None].long()).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - gold


def _chunk_xent(h, head, labels, logit_scale: float):
    return softmax_xent((h @ head) * logit_scale, labels).sum()


def chunked_lm_loss(hidden, head, labels, *, chunk: int,
                    logit_scale: float = 1.0):
    """hidden (B, S, D); head (D, V); labels (B, S).  Mean xent.  S must
    be divisible by chunk."""
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        total = total + checkpoint(
            _chunk_xent, hidden[:, i:i + chunk], head,
            labels[:, i:i + chunk], logit_scale, use_reentrant=False,
            preserve_rng_state=False)
    return total / (b * s)
