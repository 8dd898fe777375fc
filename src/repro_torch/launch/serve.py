"""Serving launcher of the PyTorch port: one ServingEngine on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --requests 8 --slots 4 --max-len 128 --decode-block 8
  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --arch recurrentgemma-2b --requests 8 --slots 4 --max-len 128

It runs on the CUDA card unless `--device cpu` is given; with no card and
the default device it exits with an error rather than fall back.  Weights
are random, from a seeded generator.  Besides the engine's stats it prints
how many times each decode-attention kernel and the RG-LRU scan kernel
were launched (0 on the CPU, where the kernels' plain versions run).
`--page-size` with a recurrent (carry) family is refused: its state has
nothing to page.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
from repro_torch.models import registry
from repro_torch.serving import EngineConfig, Request, ServingEngine


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="suncatcher-lm-100m",
                    help=f"arch id; ported: {registry.ARCH_IDS}")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (EngineConfig.max_batch)")
    ap.add_argument("--max-len", type=int, default=128,
                    help="KV-cache length per slot")
    ap.add_argument("--decode-block", type=int, default=8,
                    help="tokens decoded per host round-trip")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache page size in tokens (0 = dense "
                         "per-slot rows)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical page-pool size (paged only; default "
                         "sizes the pool dense-equivalent)")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="prefix-cache entries (paged only; 0 = off)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true",
                    help="the config's published widths (default: the "
                         "reduced smoke config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
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
    params = fns.init(torch.Generator().manual_seed(0), cfg, device)
    try:
        eng = ServingEngine(cfg, fns, params,
                            EngineConfig(max_batch=args.slots,
                                         max_len=args.max_len,
                                         decode_block=args.decode_block,
                                         page_size=args.page_size,
                                         pool_pages=args.pool_pages,
                                         prefix_cache=args.prefix_cache))
    except ValueError as err:       # e.g. --page-size on a carry family
        raise SystemExit(f"--arch {args.arch}: {err}") from None
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        eng.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(4, 16))
                                ).astype(np.int32),
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature))
    launches0 = (decode_attention.launches, paged_decode_attention.launches,
                 rglru_scan_fwd.launches)
    t0 = time.perf_counter()
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: {len(r.prompt)} prompt toks -> "
              f"{len(r.generated)} generated")
    s = eng.stats
    print(f"{cfg.name}: served {len(done)} requests on {args.slots} "
          f"slots | {s['tokens'] / dt:.0f} tok/s on {device} | "
          f"{s['host_syncs'] / max(s['tokens'], 1):.3f} host-syncs/token "
          f"(buckets={eng.buckets()}, decode_block={args.decode_block})")
    if args.page_size:
        ps = eng.page_stats()
        print(f"  paged KV: {ps['pool_pages']} pool pages x "
              f"{ps['page_size']} toks | "
              f"{s['pages_reserved']} reserved, "
              f"{s['pages_shared']} prefix-shared | "
              f"{s['prefix_hits']} prefix hits / "
              f"{s['prefix_stores']} stores | "
              f"{s['admission_stalls']} admission stalls")
    print(f"  decode-attention kernel launches: dense "
          f"{decode_attention.launches - launches0[0]}, paged "
          f"{paged_decode_attention.launches - launches0[1]}; rglru-scan "
          f"kernel launches: {rglru_scan_fwd.launches - launches0[2]}")


if __name__ == "__main__":
    main()
