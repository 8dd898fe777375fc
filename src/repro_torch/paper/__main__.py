"""Run the paper's entries and print ``name,us_per_call,derived`` CSV, as
`benchmarks/run.py` does, on the CUDA card unless `--device cpu` is given
(with no card and the default device it exits with an error rather than
fall back).  An entry that raises prints a FAILED row, the rest still run,
and the exit code is 1."""
import argparse
import importlib
import sys

import torch

from repro_torch.paper import ENTRIES, ON_DEVICE


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the orbit and DiLoCo entries "
                         "(default cuda)")
    ap.add_argument("--skip", default="",
                    help=f"comma-separated entries to exclude, of {ENTRIES}")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (pass --device cpu to run on the CPU)")
    skip = {s.strip() for s in args.skip.split(",") if s.strip()}
    unknown = skip - set(ENTRIES)
    if unknown:
        raise SystemExit(f"--skip: unknown entries {sorted(unknown)}")
    print("name,us_per_call,derived", flush=True)
    failed = 0
    for name in ENTRIES:
        if name in skip:
            continue
        try:
            mod = importlib.import_module(f"repro_torch.paper.{name}")
            out, _ = (mod.run(device=device) if name in ON_DEVICE
                      else mod.run())
            for row, us, derived in out:
                print(f'{row},{us:.1f},"{derived}"', flush=True)
        except Exception as e:  # keep the runner going
            failed += 1
            print(f'repro_torch.paper.{name},-1,"FAILED: {e!r}"', flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
