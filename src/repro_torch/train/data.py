"""Deterministic synthetic data pipeline.

Streams are a pure function of (seed, step): after a rollback or restart,
replaying step s regenerates bit-identical batches, so no data-loader
state needs checkpointing (only the step counter).  Tokens mix
Zipf-distributed unigrams with a deterministic repetition pattern (every
fourth position repeats one random token per row), a learnable
distribution, so training tests can assert actual learning.  The kinds
are the reference's: "tokens" (B, S); "codebooks" (B, n_q, S), musicgen's
codebook frames; "vlm", tokens plus the (3, B, S) M-RoPE position ids of
qwen2-vl (text positions on all three axes).

The draws go through the port's threefry (`serving/prng.py`), so the keys,
the uniforms and the repetition pattern are the reference's bit for bit.
The Zipf tokens are `searchsorted(cdf, cdf[-1] * (1 - u))` as in
`jax.random.choice(p=...)`, over a cdf summed on the host in float32 in
the order of the reference's `jnp.cumsum` (`_zipf_cdf`), so they too are
the reference's bit for bit.  (torch.cumsum of floats on the card has
no deterministic version.)
Batches are built on the device the pipeline was given.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.serving import prng


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 1024
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    n_codebooks: int = 1          # musicgen-style streams
    kind: str = "tokens"          # "tokens" | "codebooks" | "vlm"


def _zipf_probs(vocab: int) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1)
    return p / p.sum()


def _blocked_cumsum(v: np.ndarray, block: int = 16) -> np.ndarray:
    """Inclusive float32 scan in XLA's CPU association: in-order sums
    within blocks of `block`, each block plus the exclusive prefix of the
    block totals, the totals scanned the same way, recursively."""
    n = v.shape[0]
    if n <= block:
        return np.cumsum(v, dtype=np.float32)
    m = -(-n // block)
    w = np.zeros(m * block, np.float32)
    w[:n] = v
    w = np.cumsum(w.reshape(m, block), axis=1, dtype=np.float32)
    incl = _blocked_cumsum(w[:, -1].copy(), block)
    excl = np.concatenate([np.zeros(1, np.float32), incl[:-1]])
    return (w + excl[:, None]).reshape(-1)[:n]


def _zipf_cdf(vocab: int) -> np.ndarray:
    """The cdf `jax.random.choice` searches: `jnp.cumsum` of the float32
    Zipf probabilities, bit for bit."""
    return _blocked_cumsum(_zipf_probs(vocab).astype(np.float32))


def pod_step_grid(round_idx: int, n_pods: int, inner_steps: int,
                  pod_stride: int = 1_000_000) -> np.ndarray:
    """(n_pods, H) step-id grid for DiLoCo round `round_idx`: each pod
    draws from a disjoint stride-offset partition of the deterministic
    stream."""
    return ((round_idx * inner_steps + np.arange(inner_steps))[None]
            + (np.arange(n_pods) * pod_stride)[:, None]).astype(np.int32)


class SyntheticLM:
    """Deterministic, replayable synthetic LM token stream on `device`."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        if cfg.kind not in ("tokens", "codebooks", "vlm"):
            raise ValueError(f"unknown DataConfig.kind {cfg.kind!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self._cdf = torch.from_numpy(_zipf_cdf(cfg.vocab_size)).to(
            self.device)
        self._key = prng.PRNGKey(cfg.seed, self.device)

    def _draw(self, steps: torch.Tensor) -> dict:
        """Batches for a tensor of step ids: leading axes steps.shape."""
        cfg = self.cfg
        b, s1 = cfg.global_batch, cfg.seq_len + 1
        rows = (b, cfg.n_codebooks) if cfg.kind == "codebooks" else (b,)
        n = int(np.prod(rows))
        keys = prng.split(prng.fold_in(self._key, steps))    # (..., 2, 2)
        kz, kr = keys[..., 0, :], keys[..., 1, :]
        u = prng.uniform(kz, n * s1, minval=0.0)
        toks = torch.searchsorted(self._cdf, self._cdf[-1] * (1 - u))
        toks = toks.reshape(*steps.shape, *rows, s1)
        # overlay the deterministic local repetition pattern (learnable)
        rep = prng.randint(kr, n, 0, cfg.vocab_size)
        rep = rep.reshape(*steps.shape, *rows, 1)
        pattern = torch.arange(s1, device=self.device) % 4 == 3
        toks = torch.where(pattern, rep, toks).to(torch.int32)
        batch = {"tokens": toks[..., :-1].contiguous(),
                 "labels": toks[..., 1:].contiguous()}
        if cfg.kind == "vlm":
            # text-only positions: t, h and w all count the sequence
            p = torch.arange(s1 - 1, dtype=torch.int32, device=self.device)
            batch["positions"] = p.expand(*steps.shape, 3, b,
                                          s1 - 1).contiguous()
        return batch

    def _steps(self, steps) -> torch.Tensor:
        if torch.is_tensor(steps):     # already on the device: no copy
            return steps.to(device=self.device, dtype=torch.int64)
        return torch.as_tensor(np.asarray(steps, dtype=np.int64),
                               device=self.device)

    def batch_at(self, step: int) -> dict:
        """Batch for a given step: a pure function of (seed, step)."""
        return self._draw(self._steps(step))

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1

    def batch_block(self, steps) -> dict:
        """Batches for an array of step ids in one pass, leading axes
        steps.shape (fused K-step blocks use (K,), DiLoCo rounds (n_pods,
        H)): elementwise the same arithmetic as `batch_at`, so
        bit-identical to stacking its batches.  `steps` may be a tensor
        on the pipeline's device, which makes no host-to-device copy."""
        return self._draw(self._steps(steps))
