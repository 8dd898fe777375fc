"""Serving launcher of the PyTorch port: one ServingEngine, or a serving
plane of engine replicas behind a ConstellationRouter, on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --requests 8 --slots 4 --max-len 128 --decode-block 8
  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --arch recurrentgemma-2b --requests 8 --slots 4 --max-len 128
  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --arch granite-moe-1b-a400m --requests 8 --slots 4 --page-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --arch xlstm-350m --requests 8 --slots 4 --max-len 128

Serving plane: --replicas N fronts N engine replicas (one per serving
pod) with the liveness-routed session grid: requests partition by key
across pods, every in-flight slot keeps a warm standby on a neighbour
pod, and a masked pod fails over by pointer flips to the standbys (a
full drain only as a fallback; --full-drain turns replication off).
--serving-constellation takes the pod mask and admission weights from
the orbital/ISL/radiation stack, and --force-outage-at a chaos schedule
`AT[:POD[:TICKS]][,...]` (POD `*` = the busiest pod at strike time,
TICKS omitted = the rest of the run); the launcher then checks the
zero-drop contract, and with --expect-pointer-flip / --expect-rebalance
the grid's own guarantees.  --waves serves the workload in sequential
waves and checks that the compiled-variant count (`trace_count()`, the
input signatures of the engines' device entry points) stays flat after
the first, as the reference checks its jit trace count:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --replicas 3 --requests 9 --slots 2 --max-len 64 --force-outage-at 3
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --replicas 2 --requests 6 --slots 3 --max-len 64 --waves 2 \
      --max-new-tokens 48 --force-outage-at "2:1:3,10:1:3" \
      --expect-pointer-flip --expect-rebalance

--arch also takes a comma-separated list for a mixed plane: --replicas N
then builds N pods per arch group (N >= 2, so every group has a standby
pod), and requests go round-robin over the groups:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch suncatcher-lm-100m,recurrentgemma-2b --replicas 2 \
      --requests 8 --max-len 64 --max-new-tokens 32 \
      --force-outage-at "2:*:3" --expect-pointer-flip

(any comma list of ported ids, e.g. suncatcher-lm-100m,xlstm-350m).

It runs on the CUDA card unless `--device cpu` is given; with no card and
the default device it exits with an error rather than fall back.  Weights
are random, from a seeded generator.  Besides the engine's or the plane's
stats it prints how many times each decode-attention kernel and the
RG-LRU scan kernel were launched (0 on the CPU, where the kernels' plain
versions run).  `--page-size` with a recurrent (carry) family
(recurrentgemma-2b, xlstm-350m) is refused: its state has nothing to
page.  The codebook and VLM archs (musicgen-medium, qwen2-vl-2b) are
refused, as the reference's launcher refuses them: they train only.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
from repro_torch.models import registry
from repro_torch.serving import (ConstellationRouter, EngineConfig,
                                 GridConfig, Request, ServingEngine,
                                 check_forced_outage_contract,
                                 liveness_mask_fn, parse_outage_spec)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="suncatcher-lm-100m",
                    help=f"arch id, or a comma-separated list for a mixed "
                         f"plane (--replicas pods per arch); ported: "
                         f"{registry.ARCH_IDS}")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots per replica (EngineConfig.max_batch)")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving-pod replicas behind the liveness router "
                         "(1 = a single engine, no router)")
    ap.add_argument("--serving-constellation", action="store_true",
                    help="derive the serving pod mask and admission "
                         "weights from the orbital/ISL/radiation stack")
    ap.add_argument("--force-outage-at", type=str, default=None,
                    help="chaos schedule 'AT[:POD[:TICKS]][,...]': strike "
                         "pod POD ('*' or omitted = busiest) at router "
                         "tick AT for TICKS ticks (omitted = rest of "
                         "run); comma-separated (needs --replicas >= 2)")
    ap.add_argument("--full-drain", action="store_true",
                    help="no warm-standby replication: every failover is "
                         "a full export and import")
    ap.add_argument("--repl-chunk", type=int, default=None,
                    help="KV rows shipped per slot per replication tick "
                         "(default: the whole row)")
    ap.add_argument("--defer-deadline", type=int, default=100,
                    help="max ticks a failover may stay deferred before "
                         "the router raises")
    ap.add_argument("--waves", type=int, default=1,
                    help="serve the workload in N sequential waves")
    ap.add_argument("--expect-pointer-flip", action="store_true",
                    help="outage contract: require >= 1 pointer-flip "
                         "failover (standby promotion, not a full drain)")
    ap.add_argument("--expect-rebalance", action="store_true",
                    help="outage contract: require >= 1 rebalanced slot "
                         "after a pod rejoined")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    return ap


def engine_config(args) -> EngineConfig:
    return EngineConfig(max_batch=args.slots, max_len=args.max_len,
                        decode_block=args.decode_block,
                        page_size=args.page_size, pool_pages=args.pool_pages,
                        prefix_cache=args.prefix_cache)


def build_plane(builds, args):
    """Engine replicas behind a ConstellationRouter: `args.replicas` pods
    per (cfg, fns, params) build, one arch group each."""
    ecfg = engine_config(args)
    engines = [ServingEngine(cfg, fns, params, ecfg)
               for cfg, fns, params in builds
               for _ in range(args.replicas)]
    mask_fn = None
    if args.serving_constellation:
        from repro_torch.core.isl import (ConstellationLinkModel,
                                          LivenessConfig)
        mask_fn = liveness_mask_fn(ConstellationLinkModel(
            cfg=LivenessConfig(n_pods=len(engines)),
            device=torch.device(args.device)))
    forced = (parse_outage_spec(args.force_outage_at)
              if args.force_outage_at is not None else None)
    grid = GridConfig(replicate=not args.full_drain,
                      repl_chunk=args.repl_chunk,
                      defer_deadline=args.defer_deadline)
    return ConstellationRouter(engines, mask_fn=mask_fn,
                               forced_outage=forced, grid=grid)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (pass --device cpu to run the plain "
                         f"kernels on the CPU)")
    if args.force_outage_at is not None and args.replicas < 2:
        raise SystemExit("--force-outage-at needs --replicas >= 2 (a "
                         "one-pod group has nowhere to migrate)")
    archs = [a.strip() for a in args.arch.split(",") if a.strip()]
    for a in archs:
        if a not in registry.ARCH_IDS:
            raise SystemExit(f"unknown --arch {a!r}; ported: "
                             f"{registry.ARCH_IDS}")
        if registry.input_kind(a) != "tokens":
            raise SystemExit(f"--arch {a}: the serve launcher supports "
                             f"token-LM archs ({registry.input_kind(a)} "
                             f"inputs are trained only, as in the "
                             f"reference)")
    mixed = len(archs) > 1
    if mixed and args.replicas < 2:
        raise SystemExit("a mixed --arch plane needs --replicas >= 2: "
                         "standbys and failover stay inside an arch "
                         "group, so every group needs a second pod")
    builds = []
    for a in archs:
        cfg = (registry.get_config(a) if args.full
               else registry.get_reduced_config(a))
        fns = registry.model_fns(cfg)
        builds.append((cfg, fns, fns.init(torch.Generator().manual_seed(0),
                                          cfg, device)))
    cfg, fns, params = builds[0]
    try:
        if mixed or args.replicas > 1 or args.serving_constellation:
            eng = build_plane(builds, args)
        else:
            eng = ServingEngine(cfg, fns, params, engine_config(args))
    except ValueError as err:       # e.g. --page-size on a carry family
        raise SystemExit(f"--arch {args.arch}: {err}") from None
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(args.requests):
        rcfg = builds[uid % len(builds)][0]
        reqs.append(Request(
            uid=uid,
            prompt=rng.integers(0, rcfg.vocab_size,
                                size=int(rng.integers(4, 16))
                                ).astype(np.int32),
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            arch=rcfg.name if mixed else None))
    launches0 = (decode_attention.launches, paged_decode_attention.launches,
                 rglru_scan_fwd.launches)
    waves = max(1, args.waves)
    per_wave = -(-len(reqs) // waves)
    t0 = time.perf_counter()
    trace_marks = []
    done = []
    for w in range(waves):
        for r in reqs[w * per_wave:(w + 1) * per_wave]:
            eng.submit(r)
        done = eng.run()
        trace_marks.append(eng.trace_count())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: {len(r.prompt)} prompt toks -> "
              f"{len(r.generated)} generated")
    if isinstance(eng, ConstellationRouter):
        s = eng.plane_stats()
        tok = s["engines"]["tokens"]
        label = "+".join(c.name for c, _, _ in builds)
        print(f"{label}: grid of {eng.n_pods} pods x {args.slots} slots "
              f"served {len(done)} requests | {tok / dt:.0f} tok/s on "
              f"{device} | {s['pointer_flips']} pointer flips + "
              f"{s['full_migrations']} full drains "
              f"({s['migrated_slots']} slots failed over) | "
              f"{s['rebalanced_slots']} rebalanced | "
              f"{s['replication_syncs']} standby syncs "
              f"({s['replicated_rows']} delta rows vs "
              f"{s['full_rows_equiv']} full-row equiv, "
              f"{s['replicated_bytes']} bytes) | "
              f"{s['masked_pod_ticks']} masked pod-ticks | admitted/pod "
              f"{s['admitted_per_pod']} (home {s['admitted_home']}/spill "
              f"{s['admitted_spill']}) | {eng.trace_count()} traces")
        if mixed:
            for name, occ in s["arch_occupancy"].items():
                print(f"  group {name} [{occ['state_kind']}]: "
                      f"{occ['pods']} pods / {occ['slots']} slots")
        if args.force_outage_at is not None:
            check_forced_outage_contract(
                eng, done, args.requests,
                expect_pointer_flip=args.expect_pointer_flip,
                expect_rebalance=args.expect_rebalance)
            print(f"  chaos schedule '{args.force_outage_at}': zero "
                  f"drops, {s['migrated_slots']} slots failed over "
                  f"({s['pointer_flips']} flips), "
                  f"{s['rebalanced_slots']} rebalanced OK")
    else:
        s = eng.stats
        print(f"{cfg.name}: served {len(done)} requests on {args.slots} "
              f"slots | {s['tokens'] / dt:.0f} tok/s on {device} | "
              f"{s['host_syncs'] / max(s['tokens'], 1):.3f} "
              f"host-syncs/token | {eng.trace_count()} traces "
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
    if waves > 1:
        if trace_marks[-1] != trace_marks[0]:
            raise SystemExit(
                f"trace count not flat across waves: {trace_marks} — wave 1 "
                f"must run every variant the steady state needs")
        print(f"  {waves} waves served, {trace_marks[0]} traces flat")
    print(f"  decode-attention kernel launches: dense "
          f"{decode_attention.launches - launches0[0]}, paged "
          f"{paged_decode_attention.launches - launches0[1]}; rglru-scan "
          f"kernel launches: {rglru_scan_fwd.launches - launches0[2]}")


if __name__ == "__main__":
    main()
