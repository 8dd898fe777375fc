"""§3 (ref 41) DiLoCo: pod-axis (ISL) traffic vs synchronous DP, what the
§2.1 link budget supports at formation distances, and the constellation-in-
the-loop liveness profile (masked-round stats under orbital outages): a
micro DiLoCo run on `device` under the supervisor, its pods masked by the
orbital/ISL/radiation stack.  Its attention runs B3 at head_dim 16,
zero-padded to the kernel's 64 instance, on the card."""
import tempfile
import time

import torch

from repro_torch.core.isl import OpticalTerminal
from repro_torch.models import registry
from repro_torch.train.diloco import isl_bytes_per_step

CONSTELLATION_ROUNDS = 12
MICRO = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
             vocab_size=256)


def _constellation_stats(device="cuda", params=None,
                         compute_dtype="bfloat16"):
    """Micro DiLoCo run with pod masks derived from the orbital/ISL/
    radiation stack: rounds survived, masked-pod fraction, loss under
    orbital outages, plus the full-orbit mask profile.  The weights are
    the model's init from seed 0, drawn on the CPU so that every device
    starts from the same ones, in the reduced config's bf16.

    `params` and `compute_dtype` exist only for the checks, and `run`
    passes neither: the parity tests pass the reference's weights
    (`params`, on the CPU), and chip_smoke.py runs a float32 twin
    (`compute_dtype="float32"`) to hold the card to the CPU at the
    float32 limit."""
    from repro_torch.core.isl import ConstellationLinkModel, LivenessConfig
    from repro_torch.train import (AdamWConfig, DataConfig, DiLoCoConfig,
                                   DiLoCoSupervisor, FTConfig, SyntheticLM,
                                   TrainConfig, diloco_init,
                                   make_diloco_round, outer_wire_bytes)
    from repro_torch.train.tree import tree_map

    cfg = registry.get_reduced_config("suncatcher-lm-100m", **MICRO,
                                      compute_dtype=compute_dtype)
    fns = registry.model_fns(cfg)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=2,
                       total_steps=200)
    dcfg = DiLoCoConfig(n_pods=2, inner_steps=4)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                  global_batch=2), device)
    if params is None:
        params = fns.init(torch.Generator().manual_seed(0), cfg, "cpu")
    params = tree_map(lambda x: x.to(device), params)
    model = ConstellationLinkModel(cfg=LivenessConfig(
        n_pods=dcfg.n_pods, outer_wire_bytes=outer_wire_bytes(params)),
        device=device)
    # exactly one orbit of rounds (n_rounds is in ROUNDS, not phase samples)
    rounds_per_orbit = max(1, round(model.period / model.round_time_s))
    _, orbit = model.mask_series(rounds_per_orbit)

    rnd = make_diloco_round(cfg, fns, tcfg, dcfg, data=data,
                            screen_window=16, supervise=True)
    with tempfile.TemporaryDirectory() as d:
        sup = DiLoCoSupervisor(
            rnd, diloco_init(params, dcfg, screen_window=16), dcfg,
            FTConfig(checkpoint_dirs=(d + "/a", d + "/b"),
                     checkpoint_every=16),
            liveness=model)
        hist = sup.run(CONSTELLATION_ROUNDS)
    n = dcfg.n_pods * len(hist)
    return {
        "rounds_survived": len(hist),
        "masked_pod_fraction": sup.stats["masked_pod_rounds"] / n,
        "straggler_pod_rounds": sup.stats["straggler_pod_rounds"],
        "outage_pod_rounds": sup.stats["outage_pod_rounds"],
        "mask_transitions": sup.stats["mask_transitions"],
        "first_loss": hist[0]["loss"],
        "last_loss": hist[-1]["loss"],
        "orbit_masked_pod_fraction": orbit["masked_pod_fraction"],
        "orbit_mask_transitions": orbit["mask_transitions"],
        "round_time_s": orbit["round_time_s"],
        "round_deadline_s": orbit["round_deadline_s"],
    }


def run(device="cuda"):
    t0 = time.time()
    rows = []
    for arch in ("command-r-35b", "qwen3-moe-30b-a3b", "suncatcher-lm-100m"):
        n = registry.get_config(arch).param_count()
        for h in (1, 50, 500):
            acct = isl_bytes_per_step(n, h, compress="int8" if h > 1
                                      else None)
            rows.append({"arch": arch, "inner_steps": h, **acct})
    term = OpticalTerminal()
    isl_bps = float(term.aggregate_bandwidth_bps(150.0))  # formation dist
    us = (time.time() - t0) * 1e6 / len(rows)
    cr = [r for r in rows if r["arch"] == "command-r-35b"]
    sync_s = cr[0]["sync_bytes_per_step"] * 8 / isl_bps
    diloco_s = cr[2]["diloco_bytes_per_step"] * 8 / isl_bps
    derived = (f"ISL@150m={isl_bps/1e12:.0f}Tbps; command-r sync sync-DP"
               f" {sync_s*1e3:.1f}ms/step vs DiLoCo(H=500,int8)"
               f" {diloco_s*1e3:.3f}ms/step ({cr[2]['reduction']:.0f}x)")

    t1 = time.time()
    cst = _constellation_stats(device)
    us_cst = (time.time() - t1) * 1e6 / CONSTELLATION_ROUNDS
    derived_cst = (
        f"{cst['rounds_survived']}/{CONSTELLATION_ROUNDS} rounds survived, "
        f"{cst['masked_pod_fraction']:.0%} pod-rounds masked "
        f"({cst['straggler_pod_rounds']} straggler/"
        f"{cst['outage_pod_rounds']} outage), "
        f"{cst['mask_transitions']} mask transitions, loss "
        f"{cst['first_loss']:.2f}->{cst['last_loss']:.2f}; orbit profile "
        f"{cst['orbit_masked_pod_fraction']:.0%} masked, "
        f"{cst['orbit_mask_transitions']} transitions")
    out = [("diloco_isl_traffic", us, derived),
           ("diloco_constellation_liveness", us_cst, derived_cst)]
    return out, {"traffic": rows, "constellation": cst}
