"""Clean fixture: near-miss patterns that must NOT fire any rule.

Guards against false-positive creep: every construct here is one the
port relies on (shape-derived host values, structural branches, the
fixed-shape forms of masked work, folded PRNG keys, host values in hot
loops, drains outside the hot scope).
"""
import numpy as np
import torch

from repro_torch.serving import prng
from repro_torch.sync import no_host_sync

LINT_HOT_ENTRY_POINTS = ["hot_loop"]
LINT_DEVICE_BLOCK_ENTRY_POINTS = ["step"]
LINT_REPLAY_SENSITIVE = True
LINT_STATE_SCOPED = True


def step(x, mask, reps, extra=None, scale: float = 1.0, cfg=None):
    # int()/float() of shape-derived values is host arithmetic
    k = max(1, int(x.shape[0] * scale))
    n = float(len(x))
    # identity, membership, string and type tests read structure only
    if extra is not None:
        x = x + extra
    state = {"x": x}
    if "x" in state:
        x = state["x"]
    if isinstance(extra, dict) or x.dtype == torch.bfloat16:
        x = x.float()
    if cfg.norm == "layernorm" or cfg.tied:
        x = x * n
    if x.device.type != "cuda":
        x = x + 0
    # the fixed-shape forms of masked and repeated work
    y = torch.where(mask > 0, x, torch.zeros_like(x))
    z = torch.repeat_interleave(y, reps, dim=0, output_size=2 * k)
    w = x.repeat_interleave(2, dim=0)
    # casts and same-device moves are not host reads
    v = w.to(torch.int32).to(device=x.device)
    if v.shape[0] != 2 * x.shape[0]:
        raise ValueError(f"bad repeat of {x}")   # an error path
    return z[:k], v, f"{x.shape}"


def fused(loss, cache):
    with no_host_sync(loss.device):
        m = torch.stack([loss, loss])
        pos = cache["pos"] + 1                 # the protocol-level row
    return m, pos


def hot_loop(xs, blocks):
    total = 0.0
    for block in blocks:
        host = np.asarray(block)               # already a host array
        total += float(host.sum())
        total += host.max().item()
        total += sum(int(t) for t in host.tolist())
    drained = np.zeros(3)
    for i in range(len(xs)):
        total += int(drained[i % 3])
    return total, torch.float32


def drain_outside_hot_scope(x):
    return x.cpu().numpy().tolist(), x.item()


def replay_keys(seed, tick, logits):
    key = prng.fold_in(prng.PRNGKey(seed), tick)
    draw = prng.categorical(key, logits)
    rng = np.random.default_rng((seed, tick))
    g = torch.Generator().manual_seed(seed + tick)
    noise = torch.rand(3, generator=g)
    return draw, rng.random(), noise
