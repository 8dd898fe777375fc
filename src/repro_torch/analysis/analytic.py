"""Analytic FLOP/byte models per architecture x step kind.

The port's copy of the reference's first-order terms, over the port's own
configs (`param_count`, `active_param_count` and the xLSTM / RG-LRU
fields `_arch_dims` reads).  The reference keeps them because XLA's CPU
`cost_analysis()` counts a while-loop body once; here they are the
numerator (`useful_flops`) and the roofline terms that a measured step on
the card is set against, priced for the `chip` given (`H100_SXM` for the
card; the default `ChipSpec()` is the paper's modelled chip).

Formulas (per GLOBAL step; divide by chip count for per-device):

  matmul FLOPs
    train:   6 * N_active * T         (fwd 2NT + bwd 4NT)
             + 2 * N_active * T       (full-remat recompute of the forward)
    prefill: 2 * N_active * T
    decode:  2 * N_active * B

  attention FLOPs (causal, score+value matmuls, per layer summed)
    full:    f * 4 * B * S^2/2 * H * hd     f = 4 for train (fwd+bwd+remat),
    window:  S^2/2 -> S * W                 f = 1 for prefill
    decode:  4 * B * kv_len * H * hd        (one query row)
    (xlstm mLSTM chunked: S^2/2 -> S*C + S*hd state term; sLSTM recurrent
     matmuls 4*H*dh^2 per token are folded into N_active.)

  HBM bytes (per device, the memory-roofline term)
    weights: gathered bf16 weights read per pass: passes * 2N / model_shards
             (train passes ~ 3: fwd + bwd + remat-fwd; serve: 1)
    opt:     10 * 4 * N / total_shards      (read p,m,v + write p,m,v, fp32)
    acts:    train: 2 * checkpoint stack bytes (write fwd + read bwd)
             ~ 2 * L * B_loc * S_loc * d * 2 / microbatch... computed from
             the model dims below.
    kv:      decode reads the whole local KV-cache slice once: its bytes.
"""
from __future__ import annotations

from repro_torch.core.system import ChipSpec


def _arch_dims(cfg):
    """(L_attn_full, L_attn_window, window, H, hd, d_model, n_layers)."""
    name = type(cfg).__name__
    if name == "XLSTMConfig":
        # mLSTM chunked quadratic within chunks of C
        return dict(kind="xlstm", L=cfg.n_layers // 2, H=cfg.n_heads,
                    hd=cfg.hd, d=cfg.d_model, chunk=cfg.mlstm_chunk)
    if name == "RGLRUConfig":
        return dict(kind="rglru", L=cfg.n_layers - 2 * cfg.n_groups
                    - cfg.n_tail_rec + cfg.n_groups,  # attn blocks = n_groups
                    H=cfg.n_heads, hd=cfg.hd, d=cfg.d_model,
                    window=cfg.window)
    return dict(kind="transformer", L=cfg.n_layers, H=cfg.n_heads,
                hd=cfg.hd, d=cfg.d_model, window=cfg.window)


def attention_flops(cfg, kind: str, batch: int, seq: int) -> float:
    a = _arch_dims(cfg)
    H, hd = a["H"], a["hd"]
    factor = 4.0 if kind == "train" else 1.0
    if kind == "decode":
        if a["kind"] == "xlstm":
            return 4.0 * batch * a["L"] * H * hd * hd  # state read q.C
        kv = min(seq, a.get("window") or seq)
        return a["L"] * 4.0 * batch * kv * H * hd
    if a["kind"] == "xlstm":
        eff = seq * a["chunk"] / 2 + seq * hd
    elif a.get("window"):
        w = min(a["window"], seq)
        eff = seq * w - w * w / 2
    else:
        eff = seq * seq / 2
    return factor * a["L"] * 4.0 * batch * eff * H * hd


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    n = cfg.active_param_count()
    t = batch * seq
    if kind == "train":
        return 8.0 * n * t + attention_flops(cfg, kind, batch, seq)
    if kind == "prefill":
        return 2.0 * n * t + attention_flops(cfg, kind, batch, seq)
    return 2.0 * n * batch + attention_flops(cfg, kind, batch, seq)


def useful_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """The MFU numerator: 6NT (train) / 2NT (serve), no remat, no attention
    bonus — the conventional definition."""
    n = cfg.active_param_count()
    t = batch * seq if kind != "decode" else batch
    return (6.0 if kind == "train" else 2.0) * n * t


def hbm_bytes_per_device(cfg, kind: str, batch: int, seq: int, *,
                         data_shards: int, model_shards: int,
                         microbatches: int = 1,
                         seq_parallel: bool = True) -> float:
    a = _arch_dims(cfg)
    n = cfg.param_count()
    total_shards = data_shards * model_shards
    d = a["d"]
    L_total = getattr(cfg, "n_layers", a["L"])
    b_loc = max(1, batch // data_shards)
    if kind == "train":
        w = 3 * 2 * n / model_shards          # gathered bf16 weights x passes
        opt = 10 * 4 * n / total_shards
        s_loc = seq // model_shards if seq_parallel else seq
        acts = 2 * (L_total * (b_loc // microbatches) * s_loc * d * 2)
        return w + opt + acts
    if kind == "prefill":
        w = 2 * n / model_shards
        s_loc = seq // model_shards if seq_parallel else seq
        acts = L_total * b_loc * s_loc * d * 2
        return w + acts
    # decode: weights + full local KV slice read
    w = 2 * n / model_shards
    if a["kind"] == "xlstm":
        kv = a["L"] * b_loc * a["H"] * a["hd"] * a["hd"] * 4
    elif a["kind"] == "rglru":
        Lr = getattr(cfg, "n_layers")
        kv = (Lr - getattr(cfg, "n_groups")) * b_loc * d * 4 \
            + getattr(cfg, "n_groups") * b_loc * min(seq, a["window"]) \
            * getattr(cfg, "n_kv_heads") * a["hd"] * 2 / model_shards
    else:
        kv = (L_total * b_loc * seq * getattr(cfg, "n_kv_heads") * a["hd"]
              * 2 * 2 / model_shards)
    return w + kv


def expected_collective_bytes(cfg, kind: str, batch: int, seq: int, *,
                              data_shards: int, model_shards: int,
                              microbatches: int = 1) -> float:
    """Design-intent per-device wire bytes/step for the sharding scheme
    the paper's pods use (Megatron-SP + TP + FSDP); the port's dry run
    (`launch/dryrun.py`) measures its own per-rank collectives beside it.

    Train, per layer: 2 SP zones x (all-gather(x) fwd + reduce-scatter(dx)
    bwd + remat re-gather) ~ 6 stream-sized transfers, + 2 output
    reduce-scatters; FSDP bf16 weight gathers x3 passes x microbatches;
    fp32 grad reduce-scatter.
    """
    a = _arch_dims(cfg)
    n = cfg.param_count()
    d = a["d"]
    L = getattr(cfg, "n_layers", a["L"])
    b_loc = max(1, batch // data_shards)
    if kind == "train":
        zones = 8.0 * L * b_loc * seq * d * 2.0
        weights = 3.0 * 2.0 * n / model_shards * microbatches
        grads = 4.0 * n / model_shards
        return zones + weights + grads
    if kind == "prefill":
        return 4.0 * L * b_loc * seq * d * 2.0
    # decode: row-parallel out-proj all-reduces + sharded-KV softmax stats
    v = getattr(cfg, "vocab_size", 0)
    return L * 4.0 * b_loc * d * 2.0 * 2.0 + b_loc * v * 2.0


def analytic_roofline(cfg, kind: str, batch: int, seq: int, *,
                      chips: int, data_shards: int, model_shards: int,
                      wire_bytes_per_device: float = 0.0,
                      microbatches: int = 1, chip: ChipSpec = ChipSpec()):
    """Three terms in seconds (per device = per step, SPMD).  The collective
    term prices `expected_collective_bytes`.  `wire_bytes_per_device` is a
    measured wire byte count per device, priced at the same link rate under
    the reference's key `collective_s_xla_cpu` (the dry run passes its
    counted wire bytes; 0 where nothing was measured)."""
    flops_dev = model_flops(cfg, kind, batch, seq) / chips
    bytes_dev = hbm_bytes_per_device(cfg, kind, batch, seq,
                                     data_shards=data_shards,
                                     model_shards=model_shards,
                                     microbatches=microbatches)
    compute_s = flops_dev / chip.peak_bf16_flops
    memory_s = bytes_dev / chip.hbm_bytes_per_s
    design_wire = expected_collective_bytes(
        cfg, kind, batch, seq, data_shards=data_shards,
        model_shards=model_shards, microbatches=microbatches)
    collective_s = design_wire / chip.ici_bytes_per_s
    collective_s_xla_cpu = wire_bytes_per_device / chip.ici_bytes_per_s
    step = max(compute_s, memory_s, collective_s)
    useful = useful_flops(cfg, kind, batch, seq)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s,
             "collective_s_xla_cpu": collective_s_xla_cpu,
             "design_wire_bytes": design_wire,
             "dominant": max((("compute", compute_s), ("memory", memory_s),
                              ("collective", collective_s)),
                             key=lambda kv: kv[1])[0],
             "step_time_s": step,
             "model_flops": useful,
             "mfu": useful / (step * chip.peak_bf16_flops * chips)
             if step else 0.0,
             "flops_per_device": flops_dev,
             "bytes_per_device": bytes_dev}
    return terms
