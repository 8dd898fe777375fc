"""End-to-end run (PyTorch port): train the ~100M-param demo LM with
DiLoCo across (emulated) satellite pods + checkpointing, on one device.

    PYTHONPATH=src python examples/torch_port/train_100m.py [--steps 300] \
        [--full] [--device cuda|cpu]

--full uses the real 100M config; the default is a reduced config that
exercises every layer of the stack (DiLoCo outer loop, int8 delta
compression accounting, checkpointing).  It runs on the CUDA card unless
`--device cpu` is given; the flash-attention kernel's (B3) launches are
printed (head_dim 64 at --full, 16 zero-padded to 64 otherwise).
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import registry
from repro_torch.train import (AdamWConfig, DataConfig, DiLoCoConfig,
                               SyntheticLM, TrainConfig, diloco_init,
                               make_inner_steps, outer_step)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.diloco import isl_bytes_per_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (pass --device cpu)")

    arch = "suncatcher-lm-100m"
    cfg = (registry.get_config(arch) if args.full
           else registry.get_reduced_config(arch))
    fns = registry.model_fns(cfg)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=10,
                       total_steps=args.steps)
    dcfg = DiLoCoConfig(n_pods=args.pods, inner_steps=args.inner)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8), device)

    params = fns.init(torch.Generator().manual_seed(0), cfg, device)
    n_params = cfg.param_count()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M pods={args.pods} "
          f"H={args.inner}")
    acct = isl_bytes_per_step(n_params, args.inner, compress="int8")
    print(f"ISL traffic: sync {acct['sync_bytes_per_step']/1e6:.1f} MB/step"
          f" -> DiLoCo+int8 {acct['diloco_bytes_per_step']/1e6:.3f} MB/step"
          f" ({acct['reduction']:.0f}x reduction)")

    d_state = diloco_init(params, dcfg)
    inner = make_inner_steps(cfg, fns, tcfg, dcfg)

    launches0 = flash_attention.launches
    with tempfile.TemporaryDirectory() as ckdir:
        s = 0
        outer_rounds = max(1, args.steps // args.inner)
        for r in range(outer_rounds):
            # pod p's i-th step draws batch s + p * 100000 + i
            steps = (s + 100000 * np.arange(dcfg.n_pods)[:, None]
                     + np.arange(dcfg.inner_steps)[None, :])
            d_state, loss = inner(d_state, data.batch_block(steps))
            d_state = outer_step(d_state, dcfg)
            s += dcfg.inner_steps
            if r % 2 == 0:
                ckpt.save({"params": d_state["global_params"],
                           "step": torch.tensor(s)}, ckdir, s, keep=2)
            print(f"outer {r:3d} step {s:4d} loss/pod "
                  f"{[f'{x:.3f}' for x in loss.tolist()]}")
    print(f"flash-attention kernel launches "
          f"{flash_attention.launches - launches0} (on {device})")
    print("OK: DiLoCo training complete")


if __name__ == "__main__":
    main()
