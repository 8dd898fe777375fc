"""Quickstart (PyTorch port): train a small LM under the full space-runtime
on one device: synthetic data, AdamW + cosine, SDC fault injection at (an
accelerated multiple of) the paper's measured orbital rate, detection
screens, checkpoint/rollback.

    PYTHONPATH=src python examples/torch_port/quickstart.py [--steps N] \
        [--device cuda|cpu]

It runs on the CUDA card unless `--device cpu` is given.  The reduced
demo LM's attention (head_dim 16) runs the flash-attention kernel (B3)
zero-padded to its 64 instance on the card; the count is printed.
"""
import argparse
import tempfile

import torch

from repro_torch.core.radiation import RadiationEnvironment, SDCInjector
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import registry
from repro_torch.train import (AdamWConfig, DataConfig, FTConfig,
                               FaultTolerantTrainer, SyntheticLM,
                               TrainConfig, init_train_state,
                               make_train_step)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60,
                    help="training steps to run (default 60)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (pass --device cpu)")

    cfg = registry.get_reduced_config("suncatcher-lm-100m")
    fns = registry.model_fns(cfg)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=5,
                       total_steps=100)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, fns,
                             device)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8), device)
    step = make_train_step(cfg, fns, tcfg)

    env = RadiationEnvironment()
    # accelerate the orbital SEE rate so a short demo actually sees events
    injector = SDCInjector(env, n_chips=256 * 81, step_time_s=1.0,
                           rate_multiplier=50.0, seed=42)
    launches0 = flash_attention.launches
    with tempfile.TemporaryDirectory() as d:
        ft = FTConfig(checkpoint_dirs=(d,),
                      checkpoint_every=min(20, max(1, args.steps // 3)))
        trainer = FaultTolerantTrainer(step, state, data, ft,
                                       injector=injector)
        try:
            hist = trainer.run(args.steps)
        finally:
            trainer.join_checkpoints()
    print(f"steps: {len(hist)}  first loss {hist[0]['loss']:.3f}  "
          f"last loss {hist[-1]['loss']:.3f}")
    print(f"fault-tolerance stats: {trainer.stats}")
    print(f"flash-attention kernel launches "
          f"{flash_attention.launches - launches0} (on {device})")
    assert hist[-1]["loss"] < hist[0]["loss"]
    print("OK: loss decreased under injected radiation faults")


if __name__ == "__main__":
    main()
