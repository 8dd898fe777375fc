"""The port's checkpointing, device screens and FaultTolerantTrainer:
the device screens against the JAX package's on one loss/gnorm sequence,
and the invariants of tests/test_training.py's TestCheckpoint,
TestFaultTolerance and TestDeviceScreens (all but the SDCInjector and
DiLoCo cases, which wait for later slices) on the port's own state."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.train import screen_init as j_screen_init  # noqa: E402
from repro.train import screen_update as j_screen_update  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import (AdamWConfig, DataConfig,  # noqa: E402
                               FaultTolerantTrainer, FTConfig, SyntheticLM,
                               TrainConfig, init_train_state,
                               make_fused_steps, make_train_step,
                               screen_init, screen_update)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.tree import tree_paths  # noqa: E402

torch.set_num_threads(1)

ARCH = "suncatcher-lm-100m"


def _tiny_setup(seed=0, lr=3e-3):
    cfg = treg.get_reduced_config(ARCH)
    fns = treg.model_fns(cfg)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=lr), warmup_steps=5,
                       total_steps=200)
    state = init_train_state(torch.Generator().manual_seed(seed), cfg, fns,
                             "cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=seed), "cpu")
    return cfg, fns, tcfg, state, data, make_train_step(cfg, fns, tcfg)


def _assert_trees_equal(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert list(pa) == list(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype, k
        assert torch.equal(pa[k], pb[k]), k


def _spiky(raw, at, factor):
    """A train step whose loss is scaled by `factor` at step `at`:
    deterministic, so it persists across replays."""
    def step(state, batch):
        st, m = raw(state, batch)
        f = torch.where(state["step"] == at, factor, 1.0)
        return st, {**m, "loss": m["loss"] * f}
    return step


# ------------------------------------------------------ device screens ----

def test_screen_update_matches_jax_on_one_sequence():
    """Flags and ring equal to the reference's, bit for bit, over a
    sequence that arms the screens, spikes both ways, goes non-finite and
    wraps the ring."""
    rng = np.random.default_rng(0)
    seq = [(1.0 + 0.1 * rng.standard_normal(), 0.5 + 0.05 *
            rng.standard_normal()) for _ in range(40)]
    seq[12] = (9.0, 0.5)           # loss spike
    seq[15] = (1.0, 20.0)          # gnorm spike
    seq[18] = (float("nan"), 0.5)  # non-finite
    seq[30] = (1.0, float("inf"))
    js, ts = j_screen_init(16), screen_init(16, "cpu")
    thr = (3.0, 10.0)
    for loss, gnorm in seq:
        js, jflags = j_screen_update(js, jnp.float32(loss),
                                     jnp.float32(gnorm), jnp.float32(thr[0]),
                                     jnp.float32(thr[1]), 8)
        ts, tflags = screen_update(ts, torch.tensor(loss),
                                   torch.tensor(gnorm),
                                   torch.tensor(thr[0]),
                                   torch.tensor(thr[1]), 8)
        for k in jflags:
            assert bool(tflags[k]) == bool(jflags[k]), k
        for k in js:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_spike_flagged_after_window_arms():
    s = screen_init(16, "cpu")
    thr_l, thr_g = torch.tensor(3.0), torch.tensor(10.0)
    for _ in range(10):
        s, flags = screen_update(s, torch.tensor(1.0), torch.tensor(0.5),
                                 thr_l, thr_g)
        assert not bool(flags["suspect"])
    s, flags = screen_update(s, torch.tensor(50.0), torch.tensor(0.5),
                             thr_l, thr_g)
    assert bool(flags["loss_spike"]) and bool(flags["suspect"])
    assert int(s["count"]) == 10          # the flagged sample stays out
    s, flags = screen_update(s, torch.tensor(1.0), torch.tensor(20.0),
                             thr_l, thr_g)
    assert bool(flags["gnorm_spike"])


def test_nonfinite_always_flags_and_quiet_before_arming():
    s = screen_init(16, "cpu")
    s, flags = screen_update(s, torch.tensor(float("nan")),
                             torch.tensor(1.0), torch.tensor(3.0),
                             torch.tensor(10.0))
    assert bool(flags["nonfinite"]) and bool(flags["suspect"])
    assert int(s["count"]) == 0
    for loss in [1.0, 100.0, 1.0]:        # before min_count: no flag
        s, flags = screen_update(s, torch.tensor(loss), torch.tensor(1.0),
                                 torch.tensor(3.0), torch.tensor(10.0))
        assert not bool(flags["suspect"])


# ---------------------------------------------------------- checkpoint ----

def test_checkpoint_roundtrip(tmp_path):
    *_, state, _, _ = _tiny_setup()
    ckpt.save(state, str(tmp_path), 7)
    step, restored = ckpt.restore_into(state, str(tmp_path))
    assert step == 7
    _assert_trees_equal(state, restored)


def test_corruption_detected_and_replica_used(tmp_path):
    *_, state, _, _ = _tiny_setup()
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ckpt.save_replicated(state, [d1, d2], 3)
    path = os.path.join(d1, "step-00000003", "arrays.npz")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt archive|checksum"):
        ckpt.restore_into(state, d1)
    step, restored = ckpt.restore_latest(state, [d1, d2])
    assert step == 3                      # served from the intact replica
    _assert_trees_equal(state, restored)


def test_retention(tmp_path):
    *_, state, _, _ = _tiny_setup()
    for s in range(5):
        ckpt.save(state, str(tmp_path), s, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step-00000003", "step-00000004"]


def test_prune_tolerates_vanished_entries(tmp_path, monkeypatch):
    *_, state, _, _ = _tiny_setup()
    d = str(tmp_path)
    ckpt.save(state, d, 7, keep=5)
    real_listdir = os.listdir
    monkeypatch.setattr(
        os, "listdir",
        lambda p: (["step-00000001", "step-00000002"] + real_listdir(p)
                   if str(p) == d else real_listdir(p)))
    ckpt._prune(d, 1)                     # ghost entries: must not raise
    monkeypatch.undo()
    assert sorted(os.listdir(d)) == ["step-00000007"]
    ckpt._prune(str(tmp_path / "never-existed"), 1)


def test_concurrent_async_saves_do_not_race(tmp_path):
    *_, state, _, _ = _tiny_setup()
    d = str(tmp_path)
    threads = [ckpt.save_async(state, d, s, keep=1) for s in range(8)]
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    step, restored = ckpt.restore_latest(state, [d])
    assert step in range(8)
    _assert_trees_equal(state, restored)


def test_async_save_copies_the_state_when_called(tmp_path):
    *_, state, _, _ = _tiny_setup()
    before = state["params"]["embed"].clone()
    t = ckpt.save_async(state, str(tmp_path), 1)
    state["params"]["embed"].add_(1.0)    # after the call: not saved
    t.join(timeout=60)
    _, restored = ckpt.restore_into(state, str(tmp_path))
    assert torch.equal(restored["params"]["embed"], before)


# ------------------------------------------------------ the supervisor ----

def test_clean_run_no_rollbacks_and_checkpoints(tmp_path):
    *_, state, data, step = _tiny_setup()
    ft = FTConfig(checkpoint_dirs=(str(tmp_path / "a"), str(tmp_path / "b")),
                  checkpoint_every=10)
    tr = FaultTolerantTrainer(step, state, data, ft)
    hist = tr.run(20)
    assert tr.stats["rollbacks"] == 0
    assert tr.stats["checkpoints"] == 3   # steps 0, 10, 20
    assert tr._ckpt_threads == []         # run() joined the writers
    assert [h["step"] for h in hist] == list(range(20))
    for d in ft.checkpoint_dirs:
        names = sorted(p for p in os.listdir(d) if p.startswith("step-"))
        assert names[-1] == "step-00000020"
    got_step, restored = ckpt.restore_latest(tr.state, ft.checkpoint_dirs)
    assert got_step == 20
    _assert_trees_equal(restored, tr.state)


def test_sdc_spike_rolled_back_through_an_injected_step(tmp_path):
    """A transient fault: the step at 15 corrupts the params it returns
    (the next loss spikes), once; the screens catch it, the supervisor
    rolls back to the checkpoint at 10 and replays cleanly."""
    *_, state, data, raw = _tiny_setup()
    hits = []

    def faulty(state, batch):
        st, m = raw(state, batch)
        if int(state["step"]) == 15 and not hits:
            hits.append(1)
            st = {**st, "params": {**st["params"],
                                   "embed": st["params"]["embed"] * 1e3}}
        return st, m
    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), checkpoint_every=10)
    tr = FaultTolerantTrainer(faulty, state, data, ft)
    hist = tr.run(25)
    assert hits and tr.stats["rollbacks"] >= 1
    assert tr.step == int(tr.state["step"]) == 25
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_injector_events_are_screened_and_rolled_back(tmp_path):
    """`injector` takes any object with the reference SDCInjector's
    maybe_inject; a forced burst is consumed once, caught and rolled
    back."""
    class Burst:
        def maybe_inject(self, params, forced_events=None):
            if not forced_events:
                return params, 0
            return {**params, "embed": params["embed"] * 1e4}, forced_events

    *_, state, data, step = _tiny_setup()
    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), checkpoint_every=10)
    tr = FaultTolerantTrainer(step, state, data, ft, injector=Burst())
    hist = tr.run(25, forced_sdc_at={15: 64})
    assert tr.stats["sdc_injected"] == 64
    assert tr.stats["rollbacks"] >= 1 and tr.stats["sdc_detected"] >= 1
    assert tr.step == 25
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_persistent_spike_widens_thresholds_and_completes(tmp_path):
    *_, state, data, raw = _tiny_setup()
    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), checkpoint_every=10)
    tr = FaultTolerantTrainer(_spiky(raw, 19, 50.0), state, data, ft)
    hist = tr.run(25)
    assert tr.step == 25
    assert tr.stats["threshold_widenings"] >= 1
    assert tr.stats["rollbacks"] > ft.max_rollbacks_per_step
    assert hist[-1]["step"] == 24


def test_persistent_nonfinite_raises_instead_of_livelock(tmp_path):
    *_, state, data, raw = _tiny_setup()
    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), checkpoint_every=10)
    tr = FaultTolerantTrainer(_spiky(raw, 19, float("nan")), state, data, ft)
    with pytest.raises(RuntimeError, match="non-finite"):
        tr.run(25)


def test_run_fused_matches_per_step_run_bitwise(tmp_path):
    """In eager PyTorch both loops run the same kernels on the same
    batches, so the fused mode trains bit-identically to the per-step
    loop (the reference's counterpart is red under jax 0.9.0), with one
    drain per K steps."""
    cfg, fns, tcfg, state, data, step = _tiny_setup()
    ft1 = FTConfig(checkpoint_dirs=(str(tmp_path / "a"),),
                   checkpoint_every=16)
    tr1 = FaultTolerantTrainer(step, state, data, ft1)
    h1 = tr1.run(24)
    ft2 = FTConfig(checkpoint_dirs=(str(tmp_path / "b"),),
                   checkpoint_every=16, drain_every=8)
    tr2 = FaultTolerantTrainer(step, state, data, ft2,
                               fused_steps=make_fused_steps(cfg, fns, tcfg))
    h2 = tr2.run_fused(24)
    _assert_trees_equal(tr1.state, tr2.state)
    assert tr2.stats["drains"] == 3
    assert [h["loss"] for h in h1] == [h["loss"] for h in h2]
    assert [h["gnorm"] for h in h1] == [h["gnorm"] for h in h2]
    # 3 drains + 2 checkpoint snapshots, against 24 + 2 per step
    assert tr2.stats["host_syncs"] == 5 and tr1.stats["host_syncs"] == 26


def test_run_fused_tail_screens_stay_armed(tmp_path):
    """The ragged tail falls back to run(); the host deques are seeded
    from the drained blocks, or a spike in the last n % K steps would
    pass with the median screens disarmed."""
    cfg, fns, tcfg, state, data, raw = _tiny_setup()
    spiky = _spiky(raw, 17, 50.0)
    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), checkpoint_every=10,
                  drain_every=8)
    tr = FaultTolerantTrainer(spiky, state, data, ft, fused_steps=(
        make_fused_steps(cfg, fns, tcfg, step_fn=spiky)))
    tr.run_fused(20)
    assert tr.step == 20
    assert tr.stats["rollbacks"] >= 1


def test_run_fused_rejects_host_driven_mechanisms(tmp_path):
    class Never:
        def maybe_inject(self, params, forced_events=None):
            return params, 0

    *_, state, data, step = _tiny_setup()
    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), drain_every=8)
    tr = FaultTolerantTrainer(step, state, data, ft, injector=Never(),
                              fused_steps=lambda *a: None)
    with pytest.raises(ValueError, match="SDCInjector"):
        tr.run_fused(16)
    tr.join_checkpoints()
    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), verify_every=4)
    tr = FaultTolerantTrainer(step, state, data, ft,
                              fused_steps=lambda *a: None)
    with pytest.raises(ValueError, match="verify_every"):
        tr.run_fused(16)


def test_run_fused_detects_and_recovers_from_spike(tmp_path):
    cfg, fns, tcfg, state, data, raw = _tiny_setup()
    spiky = _spiky(raw, 19, 50.0)
    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), checkpoint_every=10,
                  drain_every=5)
    tr = FaultTolerantTrainer(spiky, state, data, ft, fused_steps=(
        make_fused_steps(cfg, fns, tcfg, step_fn=spiky)))
    hist = tr.run_fused(25)
    assert tr.step == 25
    assert tr.stats["rollbacks"] >= 1
    assert tr.stats["threshold_widenings"] >= 1
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_verify_every_recomputes_the_step_bit_exactly(tmp_path):
    *_, state, data, step = _tiny_setup()
    ft = FTConfig(checkpoint_dirs=(str(tmp_path),), verify_every=3)
    tr = FaultTolerantTrainer(step, state, data, ft)
    tr.run(6)
    assert tr.stats["verify_failures"] == 0 and tr.stats["rollbacks"] == 0
