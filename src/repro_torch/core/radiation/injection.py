"""SEE bit-flip (SDC) injection for fault-tolerance testing.

Simulates the paper's measured single-event effects by flipping random
bits in live tensors (params, activations, gradients) at the orbital event
rate.  Undetected bit-flips are exactly the Silent Data Corruption failure
mode the paper flags as the open problem for training (§2.3); the training
loop's detection screens are validated against this injector.

The same key corrupts the same bits as the reference's
(`repro.core.radiation.injection`): keys are the port's threefry keys
(`serving/prng.py`), drawn with `split` and `randint` as jax draws them,
and `inject_tree` walks a tree's leaves in sorted-key order, as
`jax.tree.flatten` does.  The reference draws with randint's default
dtype, int32 with jax's default 32-bit types and int64 under
jax_enable_x64, which float64 tensors need: so this module draws int32
for float32, bfloat16 and float16 tensors (the reference as its launcher
runs it) and int64 for float64.  Where two draws hit one element, the
reference's scatter keeps the last draw (XLA's CPU scatter applies
updates in order, each one the original bits xor its own mask); this
module resolves duplicates the same way before it writes, so the card,
the CPU and the reference agree.
"""
from __future__ import annotations

import numpy as np
import torch

# float dtype -> (signed integer view of the same width, bits)
_BITS_FOR = {
    torch.float32: (torch.int32, 32),
    torch.bfloat16: (torch.int16, 16),
    torch.float16: (torch.int16, 16),
    torch.float64: (torch.int64, 64),
}


def _prng():
    # imported at use: repro_torch.serving imports core.isl, whose
    # liveness model imports this package
    from ...serving import prng
    return prng


def _bit_masks(nbits: int, dtype, device) -> torch.Tensor:
    """1 << b for b < nbits as the signed view's two's complement (bit
    nbits - 1 is the sign bit, as the reference's unsigned shift)."""
    vals = [1 << b for b in range(nbits)]
    vals = [v - (1 << nbits) if v >= 1 << (nbits - 1) else v for v in vals]
    return torch.tensor(vals, dtype=dtype, device=device)


def _draws(key, n: int, span: int, wide: bool) -> torch.Tensor:
    """n randint draws in [0, span) from a host key: int32 draws, or the
    int64 ones of jax_enable_x64 (`wide`)."""
    prng = _prng()
    if wide:
        return torch.tensor(prng.randint64(key, n, 0, span))
    return prng.randint(key, n, 0, span)


def flip_bits(key, x: torch.Tensor, n_flips: int = 1) -> torch.Tensor:
    """Flip `n_flips` uniformly-random bits of uniformly-random elements
    of x (a new tensor; x is not modified).  key: a (2,) threefry key;
    the draws are made on the host and copied to x's device."""
    if n_flips == 0:
        return x
    view_dtype, nbits = _BITS_FOR[x.dtype]
    bits = x.contiguous().reshape(-1).view(view_dtype)
    wide = x.dtype == torch.float64
    ki, kb = _prng().split(key.cpu())
    idx = _draws(ki, n_flips, bits.numel(), wide).to(x.device)
    mask = _bit_masks(nbits, view_dtype, x.device)[
        _draws(kb, n_flips, nbits, wide).to(x.device)]
    # each element keeps its last draw: sort the draws by element (stable,
    # so a run keeps draw order) and give every draw its run's last mask;
    # duplicate writes then carry equal values and their order is moot
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    last = torch.searchsorted(sorted_idx, idx, right=True) - 1
    out = bits.clone()
    out[idx] = bits[idx] ^ mask[order][last]
    return out.view(x.dtype).reshape(x.shape)


def count_changed_elements(a: torch.Tensor, b: torch.Tensor) -> int:
    """Number of elements whose *bit pattern* differs.

    Float comparison is the wrong detector: under flush-to-zero a
    bit-flip that turns 0.0 into a denormal is invisible to `!=`.
    Fault-tolerance checks compare bit patterns."""
    view_dtype, _ = _BITS_FOR[a.dtype]
    return int((a.contiguous().view(view_dtype)
                != b.contiguous().view(view_dtype)).sum())


def _sorted_leaves(tree) -> list:
    """Leaves in `jax.tree.flatten`'s order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    return [tree]


def _replace_sorted(tree, leaves):
    """A tree of `tree`'s structure (and key order) holding `leaves`, given
    in sorted-key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        return next(it)
    return build(tree)


def inject_tree(key, tree, n_events: int):
    """Flip `n_events` bits across a tree of tensors, leaves weighted by
    element count.  The leaf counts come from a numpy generator seeded
    with the key's last word (the reference's host-side choice); each
    leaf with flips takes the next split of the key.  The same key always
    corrupts the same locations, so failures are replayable."""
    if n_events == 0:
        return tree
    prng = _prng()
    leaves = _sorted_leaves(tree)
    float_ix = [i for i, leaf in enumerate(leaves)
                if torch.is_tensor(leaf) and leaf.dtype in _BITS_FOR]
    if not float_ix:
        return tree
    sizes = np.array([leaves[i].numel() for i in float_ix], dtype=float)
    probs = sizes / sizes.sum()
    rng = np.random.default_rng(int(key[-1]))
    counts = rng.multinomial(n_events, probs)
    for i, c in zip(float_ix, counts):
        if c:
            key, sub = prng.split(key)
            leaves[i] = flip_bits(sub, leaves[i], int(c))
    return _replace_sorted(tree, leaves)


class SDCInjector:
    """Stateful per-step injector driven by the RadiationEnvironment rates.

    Each `maybe_inject(tree)` call draws a Poisson event count for
    (n_chips x step_time) and corrupts the tree accordingly.
    `forced_events` pins a deterministic schedule for tests.  Keys and
    draws live on the host (a key is a (2,) int64 tensor); `flip_bits`
    copies the draws to each leaf's device."""

    def __init__(self, env, n_chips: int, step_time_s: float, seed: int = 0,
                 rate_multiplier: float = 1.0):
        self.env = env
        self.n_chips = n_chips
        self.step_time_s = step_time_s
        self.rate_multiplier = rate_multiplier
        self.rng = np.random.default_rng(seed)
        self.key = _prng().PRNGKey(seed)
        self.events_injected = 0

    def expected_per_step(self) -> float:
        return self.rate_multiplier * self.env.expected_events(
            self.n_chips, self.step_time_s)

    def maybe_inject(self, tree, forced_events: int | None = None):
        n = (forced_events if forced_events is not None
             else int(self.rng.poisson(self.expected_per_step())))
        if n == 0:
            return tree, 0
        self.key, sub = _prng().split(self.key)
        self.events_injected += n
        return inject_tree(sub, tree, n), n
