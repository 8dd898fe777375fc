"""Training launcher of the PyTorch port on one device: a
FaultTolerantTrainer with fused K-step drains, or DiLoCo rounds under the
DiLoCoSupervisor.

  # fault-tolerant single-replica training, fused K-step drains
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 16 \
      --seq-len 1024 --batch 8 --drain-every 8

  # DiLoCo: 2 pods, one round per host drain, int8 EF-compressed outer
  # sync, pod liveness from the orbital/ISL/radiation stack
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 32 \
      --diloco-pods 2 --inner-steps 8 --compress int8 --constellation \
      --seq-len 1024 --batch 8

  # SEE bit-flip injection at 2000x the orbital SDC rate (the per-step
  # loop: the screens detect, roll back and replay; at 1e5 a persistent
  # non-finite loss raises RuntimeError instead of livelocking)
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 16 \
      --seq-len 1024 --batch 8 --sdc-rate-multiplier 2e3

  # the codebook (musicgen-medium) and VLM (qwen2-vl-2b) archs train on
  # batches of their kind; minicpm-2b defaults to the WSD schedule
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \
      --full --steps 16 --seq-len 1024 --batch 8

  # the MoE, xLSTM and RG-LRU families train the same way (here the
  # reference launcher's DiLoCo example for granite-moe-1b-a400m, at its
  # reduced config)
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch granite-moe-1b-a400m --diloco-pods 2 --inner-steps 8 \
      --compress int8

It runs on the CUDA card unless `--device cpu` is given; with no card and
the default device it exits with an error rather than fall back.  Weights
are random, from a seeded generator; data is the synthetic stream of
`train/data.py`.  It prints the loss trajectory, the supervisor's stats,
tokens/s, host syncs per step (host drains per round with DiLoCo), the
ISL wire bytes of an outer sync, and how many times the flash-attention
kernel and the RG-LRU scan kernels (forward and backward: the RG-LRU and
xLSTM families) were launched (0 on the CPU, where their plain versions
run).
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.core.radiation import RadiationEnvironment, SDCInjector
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd,
                                                   rglru_scan_fwd)
from repro_torch.models import registry
from repro_torch.train import (AdamWConfig, DataConfig, DiLoCoConfig,
                               DiLoCoSupervisor, FaultTolerantTrainer,
                               FTConfig, SyntheticLM, TrainConfig,
                               diloco_init, init_train_state,
                               isl_bytes_per_step, make_diloco_round,
                               make_fused_steps, make_train_step,
                               outer_wire_bytes)
from repro_torch.train.tree import tree_leaves

def _launches():
    """The kernels' launch counters, to difference around a run."""
    return (flash_attention.launches, rglru_scan_fwd.launches,
            rglru_scan_bwd.launches)


def _launch_line(before) -> str:
    b3, fwd, bwd = (n - n0 for n, n0 in zip(_launches(), before))
    return (f"flash-attention kernel launches {b3} | RG-LRU scan kernel "
            f"launches: forward {fwd} backward {bwd}")


NOT_PORTED = ("device meshes (--mesh, ROADMAP A3b) of the JAX launcher "
              "are not ported yet and not accepted")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 epilog=NOT_PORTED)
    ap.add_argument("--arch", default="suncatcher-lm-100m",
                    help=f"arch id; ported: {registry.ARCH_IDS}")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="the config's published widths (default: the "
                         "reduced smoke config)")
    ap.add_argument("--schedule", default=None, choices=["cosine", "wsd"],
                    help="LR schedule (default: the arch's own, wsd for "
                         "minicpm-2b, else cosine)")
    ap.add_argument("--drain-every", type=int, default=8,
                    help="metrics-block drain cadence K (1 = per-step host "
                         "loop)")
    ap.add_argument("--sdc-rate-multiplier", type=float, default=0.0,
                    help="inject SEE bit flips into the params at this "
                         "multiple of the orbital SDC rate for 81 x 256 "
                         "chips at 1 s a step (0 = off); runs the per-step "
                         "loop")
    ap.add_argument("--diloco-pods", type=int, default=0,
                    help="run DiLoCo with this many pods (0 = off)")
    ap.add_argument("--inner-steps", type=int, default=8,
                    help="DiLoCo H: local steps between outer syncs")
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"],
                    help="error-feedback compression on the outer wire hop")
    ap.add_argument("--constellation", action="store_true",
                    help="derive DiLoCo pod masks from the orbital/ISL/"
                         "radiation stack (cluster breathing + SEFI/UECC "
                         "outages) instead of all pods live")
    ap.add_argument("--round-deadline-s", type=float, default=None,
                    help="outer-sync deadline; a pod whose cross-pod ISL "
                         "transfer exceeds it is masked as a straggler "
                         "(default: auto percentile over the orbit)")
    ap.add_argument("--round-time-s", type=float, default=None,
                    help="wall time one DiLoCo round maps to on the orbit "
                         "(default: period/16)")
    ap.add_argument("--outage-rate-multiplier", type=float, default=1.0,
                    help="scale on the measured SEFI+HBM-UECC restart "
                         "rates feeding the outage model")
    ap.add_argument("--force-rollback-at", type=int, default=None,
                    help="force one whole-round rollback at this round "
                         "(exercises the deterministic replay path)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap


def _run_diloco(args, cfg, fns, tcfg, data, device):
    """DiLoCo rounds under the DiLoCoSupervisor: per-pod rollback on the
    device, replicated async checkpoints, and (with --constellation) pod
    masks derived from the orbital/ISL/radiation stack."""
    dcfg = DiLoCoConfig(n_pods=args.diloco_pods,
                        inner_steps=args.inner_steps)
    compress = None if args.compress == "none" else args.compress
    params = fns.init(torch.Generator().manual_seed(0), cfg, device)
    window = FTConfig(checkpoint_dirs=()).gnorm_window
    d_state = diloco_init(params, dcfg, compress=compress,
                          screen_window=window)
    rnd = make_diloco_round(cfg, fns, tcfg, dcfg, compress=compress,
                            data=data, screen_window=window,
                            supervise=True)
    wire = outer_wire_bytes(params, compress)

    liveness = None
    if args.constellation:
        from repro_torch.core.isl import (ConstellationLinkModel,
                                          LivenessConfig)
        liveness = ConstellationLinkModel(cfg=LivenessConfig(
            n_pods=dcfg.n_pods, outer_wire_bytes=wire,
            round_time_s=args.round_time_s,
            round_deadline_s=args.round_deadline_s,
            outage_rate_multiplier=args.outage_rate_multiplier),
            device=device)

    n_rounds = -(-args.steps // dcfg.inner_steps)
    forced = ([args.force_rollback_at]
              if args.force_rollback_at is not None else None)
    launches0 = _launches()
    with tempfile.TemporaryDirectory() as d:
        # keep=1: a snapshot holds every pod's params, moments and EF
        ft = FTConfig(checkpoint_dirs=(os.path.join(d, "replica-a"),
                                       os.path.join(d, "replica-b")),
                      keep=1)
        sup = DiLoCoSupervisor(rnd, d_state, dcfg, ft, liveness=liveness)
        t0 = time.perf_counter()
        try:
            hist = sup.run(n_rounds, forced_rollback_at=forced)
        finally:
            sup.join_checkpoints()     # the writers must not outlive `d`
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    stats = {k: v for k, v in sup.stats.items() if v}

    acct = isl_bytes_per_step(sum(p.numel() for p in
                                  tree_leaves(params)),
                              dcfg.inner_steps, compress)
    losses = sup.mean_losses
    print(f"{cfg.name}: DiLoCo {dcfg.n_pods} pods x H={dcfg.inner_steps}, "
          f"{len(hist)} rounds on {device}, mean pod loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}, stats {stats}")
    print(f"  ISL wire: {wire/1e6:.2f} MB/pod/outer-sync "
          f"({args.compress}), {acct['reduction']:.0f}x less pod-axis "
          f"traffic than sync DP")
    tokens = (len(hist) * dcfg.n_pods * dcfg.inner_steps * args.batch
              * args.seq_len)
    print(f"  {tokens / dt:.0f} tok/s (rounds kept; replays and "
          f"checkpoints in the wall time) | {sup.stats['drains']} host "
          f"drains, one per round run ({sup.stats['drains'] - len(hist)} "
          f"rolled back) | {_launch_line(launches0)}")
    if liveness is not None:
        masked = sup.stats["masked_pod_rounds"] / (n_rounds * dcfg.n_pods)
        print(f"  constellation: round_time {liveness.round_time_s:.0f}s, "
              f"deadline {liveness.round_deadline_s:.2e}s, "
              f"{sup.stats['mask_transitions']} mask transitions, "
              f"{masked:.0%} pod-rounds masked "
              f"({sup.stats['straggler_pod_rounds']} straggler, "
              f"{sup.stats['outage_pod_rounds']} outage)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (pass --device cpu to run the plain "
                         f"kernels on the CPU)")
    if args.arch not in registry.ARCH_IDS:
        raise SystemExit(f"unknown --arch {args.arch!r}; ported: "
                         f"{registry.ARCH_IDS}")
    cfg = (registry.get_config(args.arch) if args.full
           else registry.get_reduced_config(args.arch))
    fns = registry.model_fns(cfg)
    sched = args.schedule or registry.lr_schedule(args.arch)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=args.lr), schedule=sched,
                       warmup_steps=max(2, args.steps // 10),
                       total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.batch,
                                  n_codebooks=getattr(cfg, "n_codebooks", 1),
                                  kind=registry.input_kind(args.arch)),
                       device)
    if args.diloco_pods > 0:
        _run_diloco(args, cfg, fns, tcfg, data, device)
        return
    state = init_train_state(torch.Generator().manual_seed(0), cfg, fns,
                             device)
    injector = None
    if args.sdc_rate_multiplier:
        injector = SDCInjector(RadiationEnvironment(), n_chips=81 * 256,
                               step_time_s=1.0,
                               rate_multiplier=args.sdc_rate_multiplier)
    fused = (make_fused_steps(cfg, fns, tcfg)
             if args.drain_every > 1 and injector is None else None)
    launches0 = _launches()
    with tempfile.TemporaryDirectory() as d:
        trainer = FaultTolerantTrainer(
            make_train_step(cfg, fns, tcfg), state, data,
            FTConfig(checkpoint_dirs=(d,), checkpoint_every=20,
                     drain_every=args.drain_every),
            injector=injector, fused_steps=fused)
        t0 = time.perf_counter()
        try:
            hist = (trainer.run_fused(args.steps) if fused is not None
                    else trainer.run(args.steps))
        finally:
            # a writer left running past the directory's removal would
            # report its own FileNotFoundError after the run's error
            trainer.join_checkpoints()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    mode = (f"fused drains (K={args.drain_every})" if fused is not None
            else "per-step host loop")
    print(f"{cfg.name}: {len(hist)} steps [{mode}] on {device} ({sched} "
          f"schedule, {registry.input_kind(args.arch)} batches), loss "
          f"{hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}, "
          f"ft stats {trainer.stats}")
    print(f"  {len(hist) * args.batch * args.seq_len / dt:.0f} tok/s | "
          f"{trainer.stats['host_syncs'] / len(hist):.3f} host-syncs/step | "
          f"{_launch_line(launches0)}")


if __name__ == "__main__":
    main()
