"""The port's serving plane against the JAX package's: the same requests
and outage schedules through a `ConstellationRouter` of port engines and
one of JAX engines on the same params (reduced configs, f32) give the
same tokens per uid, greedy and at T 0.8, and the same `plane_stats()`:
migrations, pointer flips, full drains, rebalances, deferrals and
reservations, mask transitions, standby syncs and replicated bytes.
Scenarios: a pointer-flip failover, a two-pod outage with a reserved
deferred flip, rejoin and rebalance, two chaos cycles, the deferral
deadline raising and shedding, the full-drain plane, a liveness trace,
incremental replication, a paged plane, a mixed transformer + RG-LRU
plane and a lockstep plane-wide param swap.  Each port plane also gives
every request the tokens of one engine serving it alone."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import serving as J  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import serving as T  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

torch.set_num_threads(1)
LM, RG = "suncatcher-lm-100m", "recurrentgemma-2b"


def _params(arch, key=0):
    """Seeded JAX params and the port's copy.  The tied embedding is
    scaled by 0.1: at the init scale a random model repeats its input
    token, so its tokens would not show a corrupted migration."""
    jcfg = jreg.get_reduced_config(arch, compute_dtype="float32")
    tcfg = treg.get_reduced_config(arch, compute_dtype="float32")
    jfns = jreg.model_fns(jcfg)
    jp = jfns.init(jax.random.PRNGKey(key), jcfg)
    jp = {**jp, "embed": jp["embed"] * 0.1}
    conv = trg if arch == RG else ttf
    tp = conv.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return {J: (jcfg, jfns, jp), T: (tcfg, treg.model_fns(tcfg), tp)}


@pytest.fixture(scope="module")
def models():
    return {LM: _params(LM), RG: _params(RG), "swap": _params(LM, key=1)}


def _greq(mod, cfg, uid, max_new=12, plen=8, arch=None):
    """A request with a chosen uid (the plane homes sessions by a hash of
    the uid); even uids are greedy, odd ones sample at T 0.8."""
    rng = np.random.default_rng(100 + uid)
    return mod.Request(uid=uid, prompt=rng.integers(
        0, cfg.vocab_size, size=plen).astype(np.int32),
        max_new_tokens=max_new, temperature=0.0 if uid % 2 == 0 else 0.8,
        arch=arch)


def _mixed_reqs(mod, cfg, n=7, max_new=10):
    rng = np.random.default_rng(0)
    return [mod.Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(3, 40))).astype(np.int32),
        max_new_tokens=max_new, temperature=0.0 if i % 2 == 0 else 0.8)
        for i in range(n)]


def _ecfg(mod, **kw):
    return mod.EngineConfig(**{**dict(max_batch=2, max_len=64,
                                      decode_block=4), **kw})


def _liveness_trace(t):
    alive = np.ones(2, bool)
    if 2 <= t < 5:
        alive[1] = False
    return alive, np.array([0.25, 0.75])


# scenario -> (archs of the pods, engine config, router kwargs (built per
# package), requests (uid, max_new, plen) or "mixed", expectations on the
# port plane's stats)
SCENARIOS = {
    "pointer-flip": dict(
        pods=[LM] * 3, reqs=[(1, 12, 8), (2, 12, 8)],
        router=lambda m: dict(forced_outage=m.ForcedOutage(at_tick=2, pod=1)),
        expect=dict(pointer_flips=2, full_migrations=0, migrated_slots=2)),
    "two-pod-outage-reserved": dict(
        pods=[LM] * 3, reqs=[(0, 14, 8), (1, 24, 8), (3, 24, 8)],
        router=lambda m: dict(forced_outage=m.parse_outage_spec("2:1,2:2")),
        expect=dict(pointer_flips=2, full_migrations=0),
        at_least=dict(deferred_slot_migrations=1, reserved_slot_ticks=1,
                      deferred_max_age=1)),
    "rejoin-rebalance": dict(
        pods=[LM] * 2, reqs=[(0, 30, 8), (1, 30, 8)],
        router=lambda m: dict(forced_outage=m.parse_outage_spec("2:1:3")),
        at_least=dict(pointer_flips=1, rejoins=1, rebalances=1,
                      rebalanced_slots=1)),
    "chaos-cycles": dict(
        pods=[LM] * 2, reqs=[(0, 52, 8), (1, 52, 8)],
        router=lambda m: dict(
            forced_outage=m.parse_outage_spec("2:1:3,8:1:3")),
        at_least=dict(pointer_flips=2, rejoins=2)),
    "deadline-raises": dict(
        pods=[LM] * 2, reqs=[(u, 30, 8) for u in range(4)],
        router=lambda m: dict(forced_outage=m.parse_outage_spec("2:1"),
                              grid=m.GridConfig(defer_deadline=3)),
        raises="starvation"),
    "deadline-sheds": dict(
        pods=[LM] * 2, reqs=[(u, 30, 8) for u in range(4)],
        router=lambda m: dict(forced_outage=m.parse_outage_spec("2:1"),
                              grid=m.GridConfig(defer_deadline=3,
                                                shed_on_deadline=True)),
        expect=dict(dropped_deferred=2), at_least=dict(deferred_max_age=3)),
    "full-drain": dict(
        pods=[LM] * 3, reqs="mixed",
        router=lambda m: dict(forced_outage=m.ForcedOutage(at_tick=2),
                              grid=m.GridConfig(replicate=False)),
        expect=dict(pointer_flips=0), at_least=dict(migrated_slots=1)),
    "liveness-trace": dict(
        pods=[LM] * 2, reqs=[(u, 8, 8) for u in range(8)],
        router=lambda m: dict(mask_fn=_liveness_trace),
        at_least=dict(masked_pod_ticks=1, mask_transitions=2)),
    "incremental-replication": dict(
        pods=[LM] * 2, reqs=[(0, 20, 16), (1, 20, 16)],
        router=lambda m: dict(grid=m.GridConfig(repl_chunk=4)),
        at_least=dict(replication_syncs=2)),
    "paged": dict(
        pods=[LM] * 2, ecfg=dict(max_batch=4, page_size=16, pool_pages=16,
                                 prefix_cache=2),
        reqs=[(u, 48, 20) for u in range(4)],
        router=lambda m: dict(
            forced_outage=m.parse_outage_spec("5:1:3,11:0:2"),
            grid=m.GridConfig(repl_chunk=8)),
        at_least=dict(pointer_flips=2, rebalanced_slots=1)),
    "mixed-arch": dict(
        pods=[LM, LM, RG, RG], ecfg=dict(max_batch=4),
        reqs=[(u, 32, 8) for u in range(8)],
        router=lambda m: dict(
            forced_outage=m.parse_outage_spec("2:*:3,4:3:3")),
        at_least=dict(pointer_flips=2)),
}


def _build(mod, models, name):
    sc = SCENARIOS[name]
    engines = [mod.ServingEngine(*models[a][mod],
                                 _ecfg(mod, **sc.get("ecfg", {})))
               for a in sc["pods"]]
    return mod.ConstellationRouter(engines, **sc["router"](mod))


def _requests(mod, models, name):
    sc = SCENARIOS[name]
    cfg = models[LM][mod][0]
    if sc["reqs"] == "mixed":
        return _mixed_reqs(mod, cfg)
    mixed = len(set(sc["pods"])) > 1
    out = []
    for uid, max_new, plen in sc["reqs"]:
        arch = (LM, RG)[uid % 2] if mixed else LM
        acfg = models[arch][mod][0]
        out.append(_greq(mod, acfg, uid, max_new, plen,
                         arch=acfg.name if mixed else None))
    return out


def _serve(mod, models, name):
    """Run a scenario's plane; returns (tokens per finished uid, dropped
    uids, plane_stats, stall count, the error message or None, the
    (request arch, destination arch) of every move)."""
    plane = _build(mod, models, name)
    moves = []
    relocate = plane._relocate

    def spy(sess, dst, dslot, **kw):
        moves.append((sess.req.arch or plane.engines[0].model_cfg.name,
                      plane.engines[dst].model_cfg.name))
        return relocate(sess, dst, dslot, **kw)
    plane._relocate = spy
    for r in _requests(mod, models, name):
        plane.submit(r)
    err = None
    try:
        plane.run()
    except RuntimeError as e:
        err = str(e)
    return ({r.uid: r.generated for r in plane.finished},
            sorted(r.uid for r in plane.dropped), plane.plane_stats(),
            len(plane.failover_stalls), err, moves, plane)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plane_matches_the_jax_plane(models, name):
    want = _serve(J, models, name)
    got = _serve(T, models, name)
    assert got[0] == want[0]                     # tokens per uid
    assert got[1] == want[1]                     # shed requests
    assert got[2] == want[2]                     # every plane_stats() key
    assert got[3] == want[3]                     # stalls measured
    assert got[4] == want[4]                     # the deadline's error
    assert got[5] == want[5]                     # every move
    sc = SCENARIOS[name]
    stats = got[2]
    for k, v in sc.get("expect", {}).items():
        assert stats[k] == v, (k, stats[k])
    for k, v in sc.get("at_least", {}).items():
        assert stats[k] >= v, (k, stats[k])
    if "raises" in sc:
        assert sc["raises"] in got[4]
    else:
        assert got[4] is None and stats["dropped_deferred"] == len(got[1])
    assert all(a == b for a, b in got[5])        # moves stay in the group
    if name == "mixed-arch":                      # a flip in the carry group
        carry = models[RG][T][0].name
        assert stats["arch_occupancy"][carry]["state_kind"] == "carry"
        assert (carry, carry) in got[5]


@pytest.mark.parametrize("name", sorted(
    n for n in SCENARIOS if "raises" not in SCENARIOS[n]))
def test_plane_equals_one_engine_serving_alone(models, name):
    """Placement, failover and rebalance never change a request's tokens:
    each equals one engine serving the request alone on its stream."""
    tokens, _, _, _, _, _, plane = _serve(T, models, name)
    assert tokens
    for r in plane.finished:
        arch = next(a for a in (LM, RG)
                    if models[a][T][0].name == (r.arch or
                                                models[LM][T][0].name))
        eng = T.ServingEngine(*models[arch][T],
                              _ecfg(T, **SCENARIOS[name].get("ecfg", {})))
        alone = T.Request(uid=r.uid, prompt=r.prompt,
                          max_new_tokens=r.max_new_tokens,
                          temperature=r.temperature)
        alone._seq = r._seq
        eng.submit(alone)
        assert eng.run()[0].generated == r.generated, r.uid


def test_replicated_bytes_follow_the_axis_declarations(models):
    """A windowed sync is charged carry bytes + per_pos x rows shipped, a
    carry sync its whole row: the bytes the specs' `row_wire_bytes`
    predict, which equal the reference's."""
    _, _, st, _, _, _, plane = _serve(T, models, "incremental-replication")
    full_b, per_pos_b, carry_b = plane.engines[0].spec.row_wire_bytes(64)
    assert per_pos_b > 0
    n_syncs = st["full_bytes_equiv"] // full_b
    assert st["replicated_bytes"] == (carry_b * n_syncs
                                      + per_pos_b * st["replicated_rows"])
    assert 0 < st["replicated_bytes"] < st["full_bytes_equiv"]
    _, _, st, _, _, _, plane = _serve(T, models, "mixed-arch")
    rg = next(e for e in plane.engines if not e.spec.windowed)
    cfull, cper, ccarry = rg.spec.row_wire_bytes(64)
    assert cper == 0 and ccarry == cfull > 0


def test_plane_swap_is_lockstep_and_each_request_decodes_on_one_version(
        models):
    """A plane-wide swap holds admissions, drains the in-flight request on
    its admission params, then lands on every replica at once: tokens,
    versions and stats equal the JAX plane's, and each request equals a
    fresh engine serving its version alone."""
    out = {}
    for mod in (J, T):
        cfg, fns, params = models[LM][mod]
        new = models["swap"][mod][2]
        plane = mod.ConstellationRouter(
            [mod.ServingEngine(cfg, fns, params, _ecfg(mod))
             for _ in range(2)])
        for uid in (100, 101):
            plane.submit(mod.Request(uid=uid, prompt=np.arange(
                5, dtype=np.int32), max_new_tokens=2))
        plane.run()
        plane.finished.clear()
        plane.submit(_greq(mod, cfg, 0, max_new=14))
        plane.step()
        assert any(s is not None for s in plane.slots)
        assert plane.swap_params(new) == 1
        assert plane.params_version == 0             # staged, not applied
        plane.submit(_greq(mod, cfg, 1, max_new=5, plen=7))
        done = {r.uid: r for r in plane.run()}
        assert plane.params_version == 1
        assert all(e.params_version == 1 and e._pending_params is None
                   for e in plane.engines)
        assert done[0]._params_version == 0 and done[1]._params_version == 1
        out[mod] = ({u: r.generated for u, r in done.items()},
                    plane.plane_stats())
    assert out[T] == out[J]
    cfg, fns, params = models[LM][T]
    for uid, key in ((0, LM), (1, "swap")):
        eng = T.ServingEngine(cfg, fns, models[key][T][2], _ecfg(T))
        r = _greq(T, cfg, uid, max_new=14 if uid == 0 else 5,
                  plen=8 if uid == 0 else 7)
        r._seq = 2 + uid                  # the plane's seqs after warm-up
        eng.submit(r)
        assert eng.run()[0].generated == out[T][0][uid]


def test_router_refuses_what_the_reference_refuses(models):
    cfg, fns, params = models[LM][T]
    with pytest.raises(ValueError, match="max_len"):
        T.ConstellationRouter([
            T.ServingEngine(cfg, fns, params, _ecfg(T, max_len=64)),
            T.ServingEngine(cfg, fns, params, _ecfg(T, max_len=32))])
    plane = T.ConstellationRouter(
        [T.ServingEngine(cfg, fns, params, _ecfg(T)) for _ in range(2)])
    with pytest.raises(ValueError, match="must be < max_len"):
        plane.submit(T.Request(uid=0, prompt=np.zeros(64, np.int32)))
    with pytest.raises(KeyError, match="no arch group"):
        plane.submit(T.Request(uid=1, prompt=np.zeros(4, np.int32),
                               arch="nope"))
    with pytest.raises(ValueError, match="structure"):
        plane.swap_params({"not": torch.zeros(())})
    assert plane.plane_stats()["sessions_active"] == 0
