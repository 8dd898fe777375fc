"""Training launcher of the PyTorch port: one FaultTolerantTrainer on one
device, fused K-step drains by default.

  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 16 \
      --seq-len 1024 --batch 8 --drain-every 8

It runs on the CUDA card unless `--device cpu` is given; with no card and
the default device it exits with an error rather than fall back.  Weights
are random, from a seeded generator; data is the synthetic stream of
`train/data.py`.  It prints the loss trajectory, the supervisor's stats,
tokens/s, host syncs per step and how many times the flash-attention
kernel was launched (0 on the CPU, where its plain version runs).
"""
import argparse
import tempfile
import time

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import registry
from repro_torch.train import (AdamWConfig, DataConfig, FaultTolerantTrainer,
                               FTConfig, SyntheticLM, TrainConfig,
                               init_train_state, make_fused_steps,
                               make_train_step)

NOT_PORTED = ("DiLoCo (--diloco-pods, --inner-steps, --compress, "
              "--constellation), device meshes (--mesh) and the SDC "
              "injector (--sdc-rate-multiplier) of the JAX launcher are not "
              "ported yet and not accepted")


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
    ap.add_argument("--schedule", default="cosine", help="cosine|wsd")
    ap.add_argument("--drain-every", type=int, default=8,
                    help="metrics-block drain cadence K (1 = per-step host "
                         "loop)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap


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
    tcfg = TrainConfig(adamw=AdamWConfig(lr=args.lr), schedule=args.schedule,
                       warmup_steps=max(2, args.steps // 10),
                       total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.batch,
                                  kind=registry.input_kind(args.arch)),
                       device)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, fns,
                             device)
    fused = (make_fused_steps(cfg, fns, tcfg) if args.drain_every > 1
             else None)
    launches0 = flash_attention.launches
    with tempfile.TemporaryDirectory() as d:
        trainer = FaultTolerantTrainer(
            make_train_step(cfg, fns, tcfg), state, data,
            FTConfig(checkpoint_dirs=(d,), checkpoint_every=20,
                     drain_every=args.drain_every),
            fused_steps=fused)
        t0 = time.perf_counter()
        hist = (trainer.run_fused(args.steps) if fused is not None
                else trainer.run(args.steps))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    mode = (f"fused drains (K={args.drain_every})" if fused is not None
            else "per-step host loop")
    print(f"{cfg.name}: {len(hist)} steps [{mode}] on {device}, loss "
          f"{hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}, "
          f"ft stats {trainer.stats}")
    print(f"  {len(hist) * args.batch * args.seq_len / dt:.0f} tok/s | "
          f"{trainer.stats['host_syncs'] / len(hist):.3f} host-syncs/step | "
          f"flash-attention kernel launches "
          f"{flash_attention.launches - launches0}")


if __name__ == "__main__":
    main()
