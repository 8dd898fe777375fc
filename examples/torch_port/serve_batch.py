"""Batched serving (PyTorch port) with continuous batching on the demo LM,
on one device.

    PYTHONPATH=src python examples/torch_port/serve_batch.py \
        [--requests N] [--max-new N] [--device cuda|cpu]

It runs on the CUDA card unless `--device cpu` is given.  The reduced
demo LM's decode attention (head_dim 16) runs the dense decode-attention
kernel (B1) zero-padded to its 64 instance on the card; the count is
printed.
"""
import argparse

import numpy as np
import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import registry
from repro_torch.serving import EngineConfig, Request, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=12,
                    help="max new tokens per request")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (pass --device cpu)")

    cfg = registry.get_reduced_config("suncatcher-lm-100m")
    fns = registry.model_fns(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg, device)
    eng = ServingEngine(cfg, fns, params,
                        EngineConfig(max_batch=4, max_len=96))
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        eng.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(3, 12))).astype(
                                    np.int32),
            max_new_tokens=args.max_new,
            temperature=0.0 if uid % 2 == 0 else 0.7))
    launches0 = decode_attention.launches
    done = eng.run()
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: prompt[{len(r.prompt)}] -> {r.generated}")
    print(f"engine stats: {eng.stats}")
    print(f"decode-attention kernel launches: dense "
          f"{decode_attention.launches - launches0} (on {device})")
    assert len(done) == args.requests
    print(f"OK: {args.requests} requests served through 4 slots "
          f"(continuous batching)")


if __name__ == "__main__":
    main()
