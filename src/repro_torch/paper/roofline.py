"""The roofline table of the port's dry run: the counterpart of
`benchmarks/roofline.py`, over the JSONs `repro_torch.launch.dryrun`
wrote (build/dryrun/ by default).  A cell fits when its peak memory per
rank is within the memory of the chip its run was priced for.  With no
JSONs it says so and returns no rows.  Host only."""
import glob
import json
import os
import time

from repro_torch.launch.dryrun import RESULTS_DIR


def load(results_dir=RESULTS_DIR, mesh="single"):
    rows = []
    for p in sorted(glob.glob(os.path.join(results_dir, f"*_{mesh}.json"))):
        with open(p) as f:
            r = json.load(f)
        if "analytic" not in r:          # the outer-sync cells
            continue
        a = r["analytic"]
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": mesh,
            "chips": r["chips"], "chip": r["chip"],
            "peak_GiB": round(r["memory_peak_bytes"] / 2**30, 2),
            "fits": r["memory_peak_bytes"] <= r["chip_hbm_capacity_bytes"],
            "compute_s": a["compute_s"], "memory_s": a["memory_s"],
            "collective_s": a["collective_s"], "dominant": a["dominant"],
            "mfu": a["mfu"], "flops_rank": r["flops"]["total"],
            "wire_GB_rank": round(r["collectives"]["wire_bytes"] / 1e9, 1),
        })
    return rows


def run(results_dir=RESULTS_DIR):
    t0 = time.time()
    rows = load(results_dir, "single") + load(results_dir, "multi")
    us = (time.time() - t0) * 1e6 / max(len(rows), 1)
    if not rows:
        return [("roofline_dryrun_table", us,
                 f"no dry-run JSONs in {os.path.normpath(results_dir)} "
                 f"(python -m repro_torch.launch.dryrun --all)")], rows
    n_fit = sum(r["fits"] for r in rows)
    chips = ",".join(sorted({r["chip"] for r in rows}))
    derived = (f"{len(rows)} dry-run cells; {n_fit} fit the memory of "
               f"{chips}; dominant terms: "
               + ",".join(sorted({r["dominant"] for r in rows})))
    return [("roofline_dryrun_table", us, derived)], rows


if __name__ == "__main__":
    out, rows = run()
    print(out[0][2])
    for r in rows:
        print(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
              f"{r['peak_GiB']:8.2f}GiB {r['dominant']:>10s} "
              f"mfu={r['mfu']:.1%}")
