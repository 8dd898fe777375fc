"""The port's ServingEngine serving the RG-LRU family (recurrentgemma,
reduced config, f32 compute) against the JAX engine on the same params,
and the carry family's engine invariants held on the port.

The JAX model runs its default associative scan, the port's plain scan is
sequential: where a token differs, the failure reports the gap between
the port's two leading logits at that step (a near tie, or a real
fault), and the comparison stays exact."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import decode_state as jds  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.models import decode_state as tds  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402,E501

torch.set_num_threads(1)
ARCH = "recurrentgemma-2b"
HOT = 3.0        # temperature of the sampled rows in the parity workload


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_reduced_config(ARCH, compute_dtype="float32")
    tcfg = treg.get_reduced_config(ARCH, compute_dtype="float32")
    jfns = jreg.model_fns(jcfg)
    jparams = jfns.init(jax.random.PRNGKey(0), jcfg)
    tparams = trg.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
    return jcfg, jfns, jparams, tcfg, treg.model_fns(tcfg), tparams


def _workload(vocab, n=8, seed=0):
    """Prompts of 3-39 tokens: most pass the 16-slot window, and prompt +
    9 new tokens wraps the ring."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(sz)).astype(np.int32)
            for sz in rng.integers(3, 40, size=n)]


def _serve(eng, req_cls, prompts, max_new=9, hot=HOT, temps=True):
    """Odd uids sample at temperature `hot` (when `temps`), even ones are
    greedy."""
    for uid, p in enumerate(prompts):
        eng.submit(req_cls(uid=uid, prompt=p, max_new_tokens=max_new,
                           temperature=hot if temps and uid % 2 else 0.0))
    return {r.uid: r.generated for r in eng.run()}


def _ecfg(cls, **kw):
    base = dict(max_batch=3, max_len=64, decode_block=4, seed=7)
    base.update(kw)
    return cls(**base)


def _port(setup, **kw):
    _, _, _, tcfg, tfns, tparams = setup
    return ServingEngine(tcfg, tfns, tparams, _ecfg(EngineConfig, **kw))


@pytest.fixture(scope="module")
def jax_streams(setup):
    jcfg, jfns, jparams = setup[:3]
    eng = JServingEngine(jcfg, jfns, jparams, _ecfg(JEngineConfig))
    return _serve(eng, JRequest, _workload(jcfg.vocab_size))


def _first_gap(setup, prompts, got, want):
    """Where the streams part: the request, the step, and the gap between
    the port's two leading logits there (one forward pass over the prompt
    and the agreed prefix)."""
    tcfg, tparams = setup[3], setup[5]
    for uid in sorted(want):
        g, w = got.get(uid, []), want[uid]
        n = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if n is None:
            continue
        toks = np.concatenate([prompts[uid], np.asarray(w[:n], np.int32)])
        with torch.no_grad():
            logits = trg.forward(tparams, torch.from_numpy(toks)[None],
                                 tcfg)[0, -1]
        top = torch.topk(logits, 2).values
        gap = float(top[0] - top[1])
        return (f"uid {uid} differs at token {n} ({g[n]} vs {w[n]}); the "
                f"port's top-2 logit gap there is {gap:.3e}")
    return "streams differ in length only"


def test_engine_streams_match_jax_engine(setup, jax_streams):
    prompts = _workload(setup[0].vocab_size)
    got = _serve(_port(setup), Request, prompts)
    assert got == jax_streams, _first_gap(setup, prompts, got, jax_streams)
    assert all(len(v) == 9 for v in got.values())


def test_parity_workload_draws_off_the_greedy_path(setup, jax_streams):
    """The sampled rows leave the greedy stream, so the parity above covers
    the sampler, not argmax alone."""
    prompts = _workload(setup[0].vocab_size)
    greedy = _serve(_port(setup), Request, prompts, temps=False)
    assert all(greedy[u] == jax_streams[u] for u in greedy if u % 2 == 0)
    assert any(greedy[u] != jax_streams[u] for u in greedy if u % 2)


@pytest.mark.parametrize("block", [1, 8])
def test_decode_block_n_bit_identical(setup, block):
    prompts = _workload(setup[0].vocab_size, seed=3)
    base = _serve(_port(setup, decode_block=4), Request, prompts)
    assert _serve(_port(setup, decode_block=block), Request, prompts) == base


def _rows(state, slot):
    """Every state leaf's row `slot` (slot axis 1, pos axis 0), cloned."""
    out = {"pos": state["pos"][slot].clone()}
    for k, v in state.items():
        if k != "pos":
            out.update({f"{k}/{i}": leaf[:, slot].clone()
                        for i, leaf in enumerate(v)})
    return out


def test_inactive_rows_whole_state_bit_stable(setup):
    """A row whose request finished at prefill (its pos 20 past the
    ring's 16 slots) and a never-used row hold every leaf, the ring
    included, bit for bit across a decode block in which the other rows
    advance: each sub-step writes every row's ring slot pos % W, and
    `freeze` undoes the inactive rows' writes."""
    eng = _port(setup, max_batch=4, decode_block=4)
    rng = np.random.default_rng(5)
    for uid, (n, new) in enumerate(((20, 1), (9, 30), (30, 30))):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, 128, n).astype(np.int32), max_new_tokens=new))
    eng._fill_slots()
    assert eng.slots[0] is None and eng.slots[3] is None
    assert eng.slots[1] is not None and eng.slots[2] is not None
    assert int(eng.cache["pos"][0]) == 20
    before = {s: _rows(eng.cache, s) for s in range(4)}
    eng._decode_block()
    for s in (0, 3):
        after = _rows(eng.cache, s)
        for k, v in before[s].items():
            assert torch.equal(after[k], v), (s, k)
    for s in (1, 2):
        after = _rows(eng.cache, s)
        assert int(after["pos"]) == int(before[s]["pos"]) + 4
        for k in ("rec_a/0", "attn/0"):
            assert not torch.equal(after[k], before[s][k])


def test_decode_returns_the_family_schema(setup):
    """`decode` alone returns a valid state: the tree `init_state` makes,
    leaf for leaf in shape and dtype, so a caller need not `freeze`."""
    tcfg, tparams = setup[3], setup[5]
    spec = treg.model_fns(tcfg).decode_spec(tcfg, "cpu")
    st0 = spec.init_state(2, 32)
    _, st = spec.decode(tparams, st0, torch.tensor([[3], [4]],
                                                   dtype=torch.int32))
    _, st = spec.decode(tparams, st, torch.tensor([[5], [6]],
                                                  dtype=torch.int32))
    assert list(st) == list(st0)
    flat0, flat = _rows(st0, slice(None)), _rows(st, slice(None))
    assert {k: (v.shape, v.dtype) for k, v in flat.items()} == \
        {k: (v.shape, v.dtype) for k, v in flat0.items()}
    assert st["pos"].tolist() == [2, 2]


def test_eos_frees_the_slot(setup):
    eng = _port(setup, max_batch=1)
    eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                       max_new_tokens=8))
    first = eng.run()[0].generated[0]
    eng2 = _port(setup, max_batch=1)
    for uid in (1, 2):
        eng2.submit(Request(uid=uid, prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=8, eos_id=first))
    done = eng2.run()
    assert [r.generated for r in done] == [[first], [first]]
    assert eng2.slots == [None]


def test_paged_spec_refuses_the_carry_family(setup):
    jcfg, tcfg = setup[0], setup[3]
    kw = dict(page_size=16, max_batch=2, max_len=64)
    with pytest.raises(ValueError) as jerr:
        jds.paged_spec(jds.decode_spec(jcfg), **kw)
    with pytest.raises(ValueError) as terr:
        tds.paged_spec(tds.decode_spec(tcfg, "cpu"), **kw)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="does not page"):
        _port(setup, page_size=16)


@pytest.mark.parametrize("arch", ["suncatcher-lm-100m", ARCH])
def test_decode_spec_dispatch_and_state_kind_match_jax(arch):
    jcfg, tcfg = jreg.get_reduced_config(arch), treg.get_reduced_config(arch)
    jspec, tspec = jds.decode_spec(jcfg), tds.decode_spec(tcfg, "cpu")
    assert type(tspec).__name__ == type(jspec).__name__
    assert tspec.state_kind == jspec.state_kind
    assert isinstance(tspec, tds.DecodeStateSpec)
    to_list = (lambda t: [to_list(x) for x in t] if isinstance(t, tuple)
               else t)
    assert {k: to_list(v) for k, v in tspec.batch_axes().items()} == \
        {k: to_list(v) for k, v in jspec.batch_axes().items()}
    assert {k: to_list(v) for k, v in tspec.length_axes().items()} == \
        {k: to_list(v) for k, v in jspec.length_axes().items()}
    if arch != ARCH:
        paged = tds.paged_spec(tspec, page_size=16, max_batch=2, max_len=64)
        jpaged = jds.paged_spec(jspec, page_size=16, max_batch=2, max_len=64)
        assert paged.state_kind == jpaged.state_kind
    with pytest.raises(KeyError, match="no decode-state family"):
        tds.decode_spec(object(), "cpu")


def _serve_cli(*args):
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         *args], capture_output=True, text=True, env=env, cwd=root,
        timeout=240)


def test_serve_cli_serves_the_family_on_cpu_when_asked():
    proc = _serve_cli("--device", "cpu", "--requests", "2", "--slots", "2",
                      "--max-len", "64", "--max-new-tokens", "4")
    assert proc.returncode == 0, proc.stderr
    assert "recurrentgemma-2b-smoke: served 2 requests" in proc.stdout
    assert "rglru-scan kernel launches: 0" in proc.stdout


def test_serve_cli_refuses_page_size_and_a_missing_card():
    proc = _serve_cli("--device", "cpu", "--page-size", "16")
    assert proc.returncode != 0
    assert "requires a transformer KV family" in proc.stderr
    assert "Traceback" not in proc.stderr
    if torch.cuda.is_available():
        return
    proc = _serve_cli("--requests", "2", "--slots", "2", "--max-len", "64")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "Traceback" not in proc.stderr
