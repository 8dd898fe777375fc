"""Recompute the `analytic` block of the port's dry-run JSONs in place
(no rerun: a formula refresh), priced for the chip each run names, on
the mesh it records.  The DiLoCo outer-sync JSONs carry no analytic
block and are left as they are.

  PYTHONPATH=src python -m repro_torch.analysis.refresh [build/dryrun]
"""
import glob
import json
import os
import sys

from repro_torch.analysis.analytic import analytic_roofline
from repro_torch.core.system import H100_SXM, ChipSpec
from repro_torch.models import registry

CHIPS = {c.name: c for c in (ChipSpec(), H100_SXM)}


def refresh(results_dir) -> int:
    """Rewrite every cell JSON's `analytic` block; returns how many."""
    n = 0
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if "analytic" not in r:
            continue
        get = registry.get_reduced_config if r.get("reduced") \
            else registry.get_config
        sizes = r["mesh"]
        r["analytic"] = analytic_roofline(
            get(r["arch"]), r["kind"], r["global_batch"], r["seq_len"],
            chips=r["chips"],
            data_shards=sizes.get("data", 1) * sizes.get("pod", 1),
            model_shards=sizes.get("model", 1),
            wire_bytes_per_device=r.get("collectives_loop_aware", {}).get(
                "wire_bytes", 0.0),
            microbatches=r.get("microbatches", 1), chip=CHIPS[r["chip"]])
        with open(p, "w") as f:
            json.dump(r, f, indent=1)
        n += 1
    print(f"refreshed {n} in {results_dir}")
    return n


if __name__ == "__main__":
    from repro_torch.launch.dryrun import RESULTS_DIR
    refresh(sys.argv[1] if len(sys.argv) > 1 else RESULTS_DIR)
