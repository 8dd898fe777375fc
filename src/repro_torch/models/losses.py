"""LM losses: plain and sequence-chunked softmax cross-entropy.

`chunked_lm_loss` computes logits -> xent one sequence chunk at a time
under `torch.utils.checkpoint`, so the backward pass recomputes each
chunk's (B, chunk, V) logits instead of keeping the whole (B, S, V)
tensor alive: the counterpart of the reference's `jax.checkpoint` scan.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.hints import is_dtensor, shard_hint


def softmax_xent(logits, labels):
    """Per-position cross-entropy, logsumexp(logits) - logits[label], in
    f32.  The gold logit is a gather, whose backward is deterministic on
    the card under `torch.use_deterministic_algorithms(True)`.  A DTensor
    whose vocab is sharded over a "model" axis of more than one rank takes
    the vocab-parallel form (`_vocab_parallel_xent`); any other DTensor
    has its vocab gathered and runs this plain form on each rank's whole
    rows (`_rows_xent`)."""
    if is_dtensor(logits):
        if _vocab_sharded(logits):
            return _vocab_parallel_xent(logits, labels)
        return _rows_xent(logits, labels)
    logits = logits.float()
    gold = logits.gather(-1, labels[..., None].long()).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - gold


def _vocab_sharded(logits) -> bool:
    from torch.distributed.tensor import Shard
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return False
    md = names.index("model")
    return mesh.size(md) > 1 and \
        logits.placements[md] == Shard(logits.dim() - 1)


class _SumOverGroup(torch.autograd.Function):
    """An all-reduce sum over `group` whose backward passes the gradient
    through: every rank computes the same loss from the sum, so each
    rank's share of it gets the loss's gradient once."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_parallel_xent(logits, labels):
    """softmax_xent over logits whose vocab is sharded on "model": each
    rank holds a slice of the vocab, and the row max, the sum of
    exponentials and the gold logit are reduced over the model group
    (Megatron's vocab-parallel cross-entropy), so no rank holds whole
    rows.  Returns the per-position xent placed as the labels."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    md = mesh.mesh_dim_names.index("model")
    group = mesh.get_group(md)
    labels = shard_hint(labels, ("batch",) + (None,) * (labels.dim() - 1))
    out_pl = list(labels.placements)

    def local(lg, lab):
        v_loc = lg.shape[-1]
        v0 = mesh.get_local_rank(md) * v_loc
        lg = lg.float()
        m = lg.amax(dim=-1).detach()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        se = _SumOverGroup.apply(torch.exp(lg - m[..., None]).sum(-1),
                                 group)
        mine = (lab >= v0) & (lab < v0 + v_loc)
        idx = torch.clamp(lab.long() - v0, 0, v_loc - 1)
        gold = lg.gather(-1, idx[..., None]).squeeze(-1) * mine
        return m + torch.log(se) - _SumOverGroup.apply(gold, group)

    return local_map(local, out_placements=out_pl,
                     in_placements=(tuple(logits.placements),
                                    tuple(labels.placements)),
                     device_mesh=mesh, redistribute_inputs=False)(
        logits, labels)


def _rows_xent(logits, labels):
    """softmax_xent on each rank's whole rows, under `local_map`: the
    plain arithmetic on local tensors (on one rank, the plain call)."""
    from torch.distributed.tensor.experimental import local_map
    logits = shard_hint(logits, ("batch",) + (None,) * (logits.dim() - 1))
    labels = shard_hint(labels, ("batch",) + (None,) * (labels.dim() - 1))
    return local_map(softmax_xent, out_placements=list(labels.placements),
                     in_placements=(tuple(logits.placements),
                                    tuple(labels.placements)),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=False)(logits, labels)


def _chunk_xent(h, head, labels, logit_scale: float):
    logits = shard_hint(h @ head, ("batch", None, "model"))
    return softmax_xent(logits * logit_scale, labels).sum()


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
