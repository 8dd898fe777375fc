"""The port's compiled-variant count against the reference's jit trace
count: `ServingEngine.trace_count()` / `ConstellationRouter.trace_count()`
in both packages on the same workload, seed and config, mirroring the
reference's own trace-count tests:

  - tests/test_serving.py: mixed prompt lengths (<= len(buckets) + 2) and
    the paged engine (<= len(buckets) + 1);
  - tests/test_decode_state.py: flat across waves for every decode-state
    family, and flat across a mixed plane's second chaos cycle;
  - tests/test_coserve.py: flat across a param swap;
  - tests/test_router.py: repeated migrations add nothing.

The port counts the distinct input signatures (shapes, dtypes and
non-tensor arguments) its seven device entry points have run with, which
is what jax's jit cache keys on, so the counts are equal.  Each package
draws its own params from seed 0: a count depends on shapes only."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serving as jserving  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(1)

PKGS = {
    "ref": SimpleNamespace(
        registry=jreg, s=jserving,
        init=lambda fns, cfg: fns.init(jax.random.PRNGKey(0), cfg)),
    "port": SimpleNamespace(
        registry=treg, s=tserving,
        init=lambda fns, cfg: fns.init(torch.Generator().manual_seed(0),
                                       cfg, "cpu")),
}
_MODELS = {}


def _model(pkg, arch="suncatcher-lm-100m", **overrides):
    key = (pkg, arch, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        p = PKGS[pkg]
        cfg = p.registry.get_reduced_config(arch, **overrides)
        fns = p.registry.model_fns(cfg)
        _MODELS[key] = (cfg, fns, p.init(fns, cfg))
    return _MODELS[key]


def _both(scenario, *args):
    """scenario(pkg namespace, pkg name, *args) in each package."""
    with jax.enable_x64(False):
        return {k: scenario(p, k, *args) for k, p in PKGS.items()}


def _prompts(vocab, n, seed, lo=3, hi=40):
    """tests/test_serving.py::_mixed_workload."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(sz)).astype(np.int32)
            for sz in rng.integers(lo, hi, size=n)]


def _reqs(s, vocab, n, seed, max_new=10, hi=24, arch=None):
    """tests/test_decode_state.py::_reqs."""
    rng = np.random.default_rng(seed)
    return [s.Request(uid=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(3, hi))).astype(np.int32),
        max_new_tokens=max_new, temperature=0.0 if i % 2 == 0 else 0.8,
        arch=arch) for i in range(n)]


# -- tests/test_serving.py ---------------------------------------------------
def _mixed_lengths(p, pkg):
    cfg, fns, params = _model(pkg)
    eng = p.s.ServingEngine(cfg, fns, params, p.s.EngineConfig(
        max_batch=2, max_len=64, decode_block=4))
    for uid, pr in enumerate(_prompts(cfg.vocab_size, 9, 3)):
        eng.submit(p.s.Request(uid=uid, prompt=pr, max_new_tokens=6))
    assert len(eng.run()) == 9
    return eng.trace_count(), len(eng.buckets())


def test_mixed_lengths_trace_count_equals_the_reference():
    got = _both(_mixed_lengths)
    assert got["port"] == got["ref"]
    traces, n_buckets = got["port"]
    assert traces <= n_buckets + 2


def _paged(p, pkg):
    cfg, fns, params = _model(pkg)
    eng = p.s.ServingEngine(cfg, fns, params, p.s.EngineConfig(
        max_batch=2, max_len=64, page_size=16, decode_block=8, seed=7))
    for uid, pr in enumerate(_prompts(cfg.vocab_size, 9, 3)):
        eng.submit(p.s.Request(uid=uid, prompt=pr, max_new_tokens=6))
    assert len(eng.run()) == 9
    return eng.trace_count(), len(eng.buckets())


def test_paged_trace_count_equals_the_reference():
    got = _both(_paged)
    assert got["port"] == got["ref"]
    traces, n_buckets = got["port"]
    assert traces <= n_buckets + 1


# -- tests/test_decode_state.py ----------------------------------------------
def _waves(p, pkg, arch):
    cfg, fns, params = _model(pkg, arch)
    eng = p.s.ServingEngine(cfg, fns, params, p.s.EngineConfig(
        max_batch=2, max_len=64, decode_block=4))
    marks = []
    for seed in (1, 2):
        for r in _reqs(p.s, cfg.vocab_size, 3, seed):
            eng.submit(r)
        eng.run()
        marks.append(eng.trace_count())
    return marks


@pytest.mark.parametrize("arch", ["suncatcher-lm-100m", "recurrentgemma-2b",
                                  "xlstm-350m", "qwen3-moe-30b-a3b"])
def test_trace_count_flat_across_waves_equals_the_reference(arch):
    got = _both(_waves, arch)
    assert got["port"] == got["ref"]
    assert got["port"][0] == got["port"][1]


def _chaos_plane(p, pkg):
    """test_mixed_plane_chaos_zero_drops_flat_traces: two strikes on the
    carry pod of a 2 + 2 mixed plane; the second cycle adds nothing."""
    (cfg_t, fns_t, p_t) = _model(pkg, "suncatcher-lm-100m")
    (cfg_r, fns_r, p_r) = _model(pkg, "recurrentgemma-2b")
    ecfg = p.s.EngineConfig(max_batch=3, max_len=64, decode_block=4)
    engines = ([p.s.ServingEngine(cfg_t, fns_t, p_t, ecfg) for _ in range(2)]
               + [p.s.ServingEngine(cfg_r, fns_r, p_r, ecfg)
                  for _ in range(2)])
    plane = p.s.ConstellationRouter(
        engines, forced_outage=p.s.parse_outage_spec("2:2:3,9:2:3"))
    for u in (0, 1, 3):
        plane.submit(_greq(p.s, cfg_t, u))
    for u in (100, 101, 102):
        plane.submit(_greq(p.s, cfg_r, u))
    while plane.tick < 8 and (plane.queue or any(
            s is not None for s in plane.slots)):
        plane.step()
    t0 = plane.trace_count()
    done = plane.run()
    assert len(done) == 6 and not plane.dropped
    assert plane.stats["pointer_flips"] >= 2
    return t0, plane.trace_count()


def _greq(s, cfg, uid):
    """tests/test_decode_state.py::_greq at max_new 32."""
    rng = np.random.default_rng(100 + uid)
    return s.Request(uid=uid, prompt=rng.integers(
        0, cfg.vocab_size, size=8).astype(np.int32), max_new_tokens=32,
        temperature=0.0 if uid % 2 == 0 else 0.8, arch=cfg.name)


def test_mixed_plane_chaos_trace_count_equals_the_reference():
    got = _both(_chaos_plane)
    assert got["port"] == got["ref"]
    assert got["port"][0] == got["port"][1]


# -- tests/test_coserve.py ---------------------------------------------------
MICRO = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
             vocab_size=256)


def _swap(p, pkg):
    cfg, fns, pa = _model(pkg, **MICRO)
    pb = PKGS[pkg].init(fns, cfg)
    prompts = [np.arange(4, dtype=np.int32) + i for i in range(3)]
    eng = p.s.ServingEngine(cfg, fns, pa, p.s.EngineConfig(max_batch=2,
                                                           max_len=64))
    for uid, pr in enumerate(prompts):
        eng.submit(p.s.Request(uid=uid, prompt=pr, max_new_tokens=6))
    eng.run()
    t0 = eng.trace_count()
    eng.swap_params(pb)
    assert eng.params_version == 1
    for uid, pr in enumerate(prompts):
        eng.submit(p.s.Request(uid=uid + 10, prompt=pr, max_new_tokens=6))
    eng.run()
    return t0, eng.trace_count()


def test_swap_trace_count_equals_the_reference():
    got = _both(_swap)
    assert got["port"] == got["ref"]
    assert got["port"][0] == got["port"][1]


# -- tests/test_router.py ----------------------------------------------------
def _migrations(p, pkg):
    cfg, fns, params = _model(pkg)
    ecfg = p.s.EngineConfig(max_batch=2, max_len=64, decode_block=4)
    src = p.s.ServingEngine(cfg, fns, params, ecfg)
    dst = p.s.ServingEngine(cfg, fns, params, ecfg)
    marks = []
    for uid in range(4):
        rng = np.random.default_rng(3 + uid)
        src.submit(p.s.Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, size=10).astype(np.int32),
            max_new_tokens=14, temperature=0.7))
        src.step()
        src.step()
        slot = next(i for i, s in enumerate(src.slots) if s is not None)
        dst.import_slots(src.export_slots([slot]))
        dst.run()
        marks.append(src.trace_count() + dst.trace_count())
    return marks


def test_migration_trace_count_equals_the_reference():
    got = _both(_migrations)
    assert got["port"] == got["ref"]
    assert len(set(got["port"])) == 1            # migrations add nothing


# -- the serve launcher ------------------------------------------------------
def test_serve_launcher_checks_traces_flat_across_waves():
    from repro_torch.launch import serve
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--device", "cpu", "--requests", "4", "--slots", "2",
                    "--max-len", "64", "--max-new-tokens", "4",
                    "--waves", "2"])
    text = out.getvalue()
    assert "2 waves served, 2 traces flat" in text
    assert "| 2 traces (buckets=" in text
