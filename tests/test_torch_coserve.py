"""Serving/training co-residency in the port: the ParamPublisher against
the JAX package's (the sink calls of tests/test_coserve.py's schedules,
bitwise), the engine's param hot-swap, and `run_coserve` end to end —
rounds, publication, a forced rollback and live traffic in one process,
with every request's tokens equal to those of a fresh engine serving,
alone, the param version it was admitted under.  The co-serve CLI runs on
the CPU when asked to, refuses the default card without one and refuses
an outage schedule without a second replica to fail over to."""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.train import ParamPublisher as JPublisher  # noqa: E402
from repro.train import PublishConfig as JPublishConfig  # noqa: E402
from repro_torch.launch.coserve import run_coserve  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402,E501
from repro_torch.train import (AdamWConfig, DataConfig,  # noqa: E402
                               DiLoCoConfig, DiLoCoSupervisor, FTConfig,
                               ParamPublisher, PublishConfig, SyntheticLM,
                               TrainConfig, diloco_init, make_diloco_round,
                               snapshot_global_params)
from repro_torch.train.tree import tree_map, tree_paths  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MICRO = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
             vocab_size=256)


# -------------------------------------------- the publisher vs the JAX ----

def _schedule_watermark(pub, state):
    out = [pub.on_round_complete(1, state(1)), pub.advance(1, 0)]
    pub.on_round_complete(2, state(2))
    out += [pub.advance(2, 2), pub.advance(2, 2)]
    pub.on_round_complete(3, state(3))
    pub.on_round_complete(4, state(4))
    return out + [pub.advance(4, 4)]


def _schedule_rollback(pub, state):
    for r in (1, 2, 3):
        pub.on_round_complete(r, state(r))
    out = [pub.advance(3, 2)]
    pub.on_rollback(2)
    out.append(pub.advance(3, 3))
    pub.on_round_complete(3, state(3))
    return out + [pub.advance(3, 3)]


def _schedule_cadence(pub, state):
    for r in (1, 2, 3, 4):
        pub.on_round_complete(r, state(r))
    return [pub.advance(4, 4)]


@pytest.mark.parametrize("schedule,cfg", [
    (_schedule_watermark, dict(holdback_rounds=1)),
    (_schedule_rollback, dict(holdback_rounds=0)),
    (_schedule_cadence, dict(publish_every=2, holdback_rounds=0))])
def test_publisher_sink_calls_match_jax(schedule, cfg):
    recs = {}
    for name, klass, conf, full in (
            ("jax", JPublisher, JPublishConfig,
             lambda r: {"global_params": {"w": jnp.full((3,), float(r))}}),
            ("port", ParamPublisher, PublishConfig,
             lambda r: {"global_params": {"w": torch.full((3,), float(r))}}
             )):
        rec = []
        pub = klass(lambda p: rec.append(float(p["w"][0])), conf(**cfg))
        ret = schedule(pub, full)
        recs[name] = (rec, ret, pub.stats, pub.published_round)
    assert recs["port"] == recs["jax"]


def test_bad_publish_config_rejected():
    with pytest.raises(ValueError):
        PublishConfig(publish_every=0)
    with pytest.raises(ValueError):
        PublishConfig(holdback_rounds=-1)


# ------------------------------------------------ the port's co-serving --

@pytest.fixture(scope="module")
def micro():
    cfg = treg.get_reduced_config("suncatcher-lm-100m", **MICRO)
    fns = treg.model_fns(cfg)
    data = SyntheticLM(DataConfig(vocab_size=256, seq_len=8,
                                  global_batch=2), "cpu")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=2,
                       total_steps=100)
    dcfg = DiLoCoConfig(n_pods=2, inner_steps=4)
    rnd = make_diloco_round(cfg, fns, tcfg, dcfg, data=data,
                            screen_window=16, supervise=True)
    return SimpleNamespace(
        cfg=cfg, fns=fns, dcfg=dcfg, rnd=rnd,
        params=[fns.init(torch.Generator().manual_seed(s), cfg, "cpu")
                for s in (0, 1)])


def _serve(m, params, prompts, max_new=6, slots=2, block=8):
    eng = ServingEngine(m.cfg, m.fns, params,
                        EngineConfig(max_batch=slots, max_len=64,
                                     decode_block=block))
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    return {r.uid: r.generated for r in eng.run()}


def test_snapshot_is_a_device_copy_that_outlives_the_round(micro):
    d = diloco_init(micro.params[0], micro.dcfg, screen_window=16)
    snap = snapshot_global_params(d)
    before = {k: v.clone() for k, v in tree_paths(snap).items()}
    d2, _ = micro.rnd(d, torch.as_tensor(np.arange(8).reshape(2, 4)),
                      torch.ones(2), torch.tensor([3.0, 10.0]))
    for k, v in tree_paths(snap).items():
        assert torch.equal(v, before[k])
        assert v.data_ptr() != tree_paths(d["global_params"])[k].data_ptr()
    assert any(not torch.equal(v, before[k]) for k, v in
               tree_paths(d2["global_params"]).items())


def test_forced_rollback_round_is_never_published(micro, tmp_path):
    def run(sub, forced):
        rec = []
        pub = ParamPublisher(
            lambda p: rec.append((pub.published_round,
                                  {k: v.clone() for k, v in
                                   tree_paths(p).items()})),
            PublishConfig(holdback_rounds=0))
        sup = DiLoCoSupervisor(
            micro.rnd, diloco_init(micro.params[0], micro.dcfg,
                                   screen_window=16), micro.dcfg,
            FTConfig(checkpoint_dirs=(str(tmp_path / sub),),
                     checkpoint_every=8), publisher=pub)
        sup.run(6, forced_rollback_at=forced)
        return sup, pub, rec

    _, _, clean = run("clean", None)
    s2, p2, forced = run("forced", [3])
    assert s2.stats["rollbacks"] == 1 and p2.stats["dropped_rollback"] == 1
    rounds = [r for r, _ in forced]
    assert rounds == sorted(rounds) == [r for r, _ in clean]
    assert all(r <= s2.verified_round for r in rounds)
    for (_, a), (_, b) in zip(clean, forced):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_swap_serves_the_new_params_like_a_fresh_engine(micro):
    pa, pb = micro.params
    prompts = [np.arange(4, dtype=np.int32) + i for i in range(3)]
    eng = ServingEngine(micro.cfg, micro.fns, pa,
                        EngineConfig(max_batch=2, max_len=64))
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    before = {r.uid: r.generated for r in eng.run()}
    assert eng.swap_params(pb) == 1
    assert eng.params_version == 1 and eng.stats["swaps"] == 1  # idle: now
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid + 10, prompt=p, max_new_tokens=6))
    eng.run()
    after = {r.uid - 10: r.generated for r in eng.finished if r.uid >= 10}
    assert before == _serve(micro, pa, prompts)
    assert after == _serve(micro, pb, prompts)
    assert before != after


def test_inflight_request_decodes_its_whole_generation_on_one_version(
        micro):
    pa, pb = micro.params
    long_p, short_p = np.arange(5, dtype=np.int32), \
        np.arange(7, dtype=np.int32)
    eng = ServingEngine(micro.cfg, micro.fns, pa,
                        EngineConfig(max_batch=2, max_len=64,
                                     decode_block=4))
    eng.submit(Request(uid=0, prompt=long_p, max_new_tokens=16))
    eng.step()                                   # prefill + 1 block
    assert any(s is not None for s in eng.slots)
    assert eng.swap_params(pb) == 1
    assert eng.params_version == 0               # staged, not applied
    eng.submit(Request(uid=1, prompt=short_p, max_new_tokens=5))
    done = {r.uid: r for r in eng.run()}
    assert eng.params_version == 1 and eng.stats["swaps"] == 1
    assert done[0].generated == _serve(micro, pa, [long_p], max_new=16,
                                       block=4)[0]
    assert done[1].generated == _serve(micro, pb, [short_p], max_new=5,
                                       block=4)[0]
    assert done[0]._params_version == 0 and done[1]._params_version == 1


def test_swap_rejects_a_tree_of_another_kind(micro):
    pa, _ = micro.params
    eng = ServingEngine(micro.cfg, micro.fns, pa,
                        EngineConfig(max_batch=1, max_len=64))
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params({"not": torch.zeros(())})
    with pytest.raises(ValueError, match="shape and dtype"):
        eng.swap_params(tree_map(lambda x: torch.zeros(
            tuple(x.shape) + (1,), dtype=x.dtype), pa))
    with pytest.raises(ValueError, match="shape and dtype"):
        eng.swap_params(tree_map(lambda x: x.to(torch.float16), pa))
    assert eng.params_version == 0 and eng._pending_params is None


def test_coserve_end_to_end_never_mixes_versions(micro, tmp_path):
    d_state = diloco_init(micro.params[0], micro.dcfg, screen_window=16)
    eng = ServingEngine(micro.cfg, micro.fns,
                        snapshot_global_params(d_state),
                        EngineConfig(max_batch=2, max_len=64,
                                     decode_block=4))
    versions = {0: snapshot_global_params(d_state)}

    def sink(p):
        versions[eng.swap_params(p)] = p
    pub = ParamPublisher(sink, PublishConfig(holdback_rounds=0))
    sup = DiLoCoSupervisor(micro.rnd, d_state, micro.dcfg,
                           FTConfig(checkpoint_dirs=(str(tmp_path / "a"),),
                                    checkpoint_every=8), publisher=pub)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, 256, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new_tokens=int(rng.integers(4, 12))) for i in range(8)]
    prompts = {r.uid: (r.prompt, r.max_new_tokens) for r in reqs}
    done = run_coserve(sup, eng, reqs, 6, forced_rollback_at=[3])

    assert len(done) == 8 and all(r.done for r in done)
    assert pub.stats["dropped_rollback"] >= 1
    assert 1 <= eng.stats["swaps"] <= pub.stats["published"]
    assert pub.published_round <= sup.verified_round
    assert eng._pending_params is None
    assert len({r._params_version for r in done}) >= 2
    for r in done:
        prompt, max_new = prompts[r.uid]
        alone = _serve(micro, versions[r._params_version], [prompt],
                       max_new=max_new, slots=1, block=4)[0]
        assert r.generated == alone, (r.uid, r._params_version)


# ------------------------------------------------------------------ CLI --

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.coserve", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)


def test_coserve_cli_runs_on_cpu_when_asked():
    proc = _cli("--device", "cpu", "--steps", "16", "--inner-steps", "4",
                "--force-rollback-at", "1", "--constellation")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "co-resident 4 DiLoCo rounds x H=4 (2 pods) + 8 requests" in out
    assert "1 dropped by rollback, 1 whole-round rollbacks" in out
    assert "live param swaps" in out
    assert "decode attention 0, flash attention 0" in out


def test_coserve_cli_refuses_the_default_card_and_router_flags():
    if not torch.cuda.is_available():
        proc = _cli("--steps", "4")
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr
        assert "Traceback" not in proc.stderr
    proc = _cli("--device", "cpu", "--force-outage-at", "2")
    assert proc.returncode != 0
    assert "needs --replicas >= 2" in proc.stderr
    assert "Traceback" not in proc.stderr
