"""The port's ServingEngine against the JAX engine on the same params
(reduced demo config, f32 compute, inputs from numpy): greedy and sampled
token streams, dense and paged; plus the reference's engine invariants
(tests/test_serving.py) held on the port."""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402,E501

torch.set_num_threads(1)
ARCH = "suncatcher-lm-100m"
HOT = 3.0        # temperature of the sampled rows in the parity workload


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_reduced_config(ARCH, compute_dtype="float32")
    tcfg = treg.get_reduced_config(ARCH, compute_dtype="float32")
    jfns = jreg.model_fns(jcfg)
    jparams = jfns.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jfns, jparams, tcfg, treg.model_fns(tcfg), tparams


def _mixed_workload(vocab, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(sz)).astype(np.int32)
            for sz in rng.integers(3, 40, size=n)]


def _serve(eng, req_cls, prompts, max_new=9, temps=True, hot=0.8):
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
    """The JAX engine's greedy + sampled streams on the mixed workload
    (dense; the reference holds its paged engine bitwise equal).  The
    random model's logits are peaked, so the sampled rows run hot enough
    to leave the greedy path."""
    jcfg, jfns, jparams = setup[:3]
    eng = JServingEngine(jcfg, jfns, jparams, _ecfg(JEngineConfig))
    return _serve(eng, JRequest, _mixed_workload(jcfg.vocab_size, n=8),
                  hot=HOT)


@pytest.mark.parametrize("layout", [dict(),
                                    dict(page_size=16),
                                    dict(page_size=16, pool_pages=10,
                                         prefix_cache=2)])
def test_engine_streams_match_jax_engine(setup, jax_streams, layout):
    prompts = _mixed_workload(setup[0].vocab_size, n=8)
    got = _serve(_port(setup, **layout), Request, prompts, hot=HOT)
    assert got == jax_streams
    assert any(len(v) == 9 for v in got.values())


def test_parity_workload_draws_off_the_greedy_path(setup, jax_streams):
    """The sampled rows of the parity workload leave the greedy stream,
    so the stream parity above covers the sampler, not argmax alone."""
    prompts = _mixed_workload(setup[0].vocab_size, n=8)
    greedy = _serve(_port(setup), Request, prompts, temps=False)
    assert all(greedy[u] == jax_streams[u] for u in greedy if u % 2 == 0)
    assert any(greedy[u] != jax_streams[u] for u in greedy if u % 2)


@pytest.mark.parametrize("page_size", [0, 16])
def test_engine_matches_jax_engine_through_pallas_decode_kernels(
        setup, monkeypatch, page_size):
    """Second oracle for the kernel path: the JAX engine with
    attn_impl="pallas" under REPRO_DECODE_ATTN=interpret runs the Pallas
    decode kernels (interpret mode) on every decode sub-step."""
    jcfg, jfns, jparams = setup[:3]
    pcfg = replace(jcfg, attn_impl="pallas")
    prompts = _mixed_workload(jcfg.vocab_size, n=3, seed=9)
    monkeypatch.setenv("REPRO_DECODE_ATTN", "interpret")
    jeng = JServingEngine(pcfg, jfns, jparams,
                          _ecfg(JEngineConfig, max_batch=2,
                                page_size=page_size))
    want = _serve(jeng, JRequest, prompts, max_new=5, temps=False)
    got = _serve(_port(setup, max_batch=2, page_size=page_size), Request,
                 prompts, max_new=5, temps=False)
    assert got == want


def test_paged_admission_stats_match_jax_engine(setup):
    """Undersized pool + prefix cache: the host-side page plan (stalls,
    reservations, prefix hits) is the reference's, step for step."""
    jcfg, jfns, jparams = setup[:3]
    head = np.arange(32, dtype=np.int32)
    prompts = [np.concatenate([head, np.full(3 + i, i, np.int32)])
               for i in range(4)] + _mixed_workload(jcfg.vocab_size, n=3)
    kw = dict(max_batch=2, page_size=16, pool_pages=8, prefix_cache=2)
    jeng = JServingEngine(jcfg, jfns, jparams, _ecfg(JEngineConfig, **kw))
    want = _serve(jeng, JRequest, prompts, max_new=6)
    teng = _port(setup, **kw)
    assert _serve(teng, Request, prompts, max_new=6) == want
    for key in ("tokens", "host_syncs", "decode_blocks", "pages_reserved",
                "pages_shared", "prefix_hits", "prefix_stores",
                "admission_stalls"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.page_stats() == jeng.page_stats()


# --------------------------------- the reference's engine invariants ----

def test_greedy_engine_matches_manual_decode(setup):
    _, _, _, tcfg, tfns, tparams = setup
    prompt = np.arange(5, dtype=np.int32)
    eng = _port(setup)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
    done = eng.run()
    cache = tfns.init_cache(tcfg, 1, 64, device="cpu")
    lg, cache = tfns.decode_step(tparams, cache,
                                 torch.from_numpy(prompt)[None], tcfg)
    seq = [int(torch.argmax(lg[0]))]
    for _ in range(5):
        lg, cache = tfns.decode_step(tparams, cache,
                                     torch.tensor([[seq[-1]]]), tcfg)
        seq.append(int(torch.argmax(lg[0])))
    assert done[0].generated == seq


@pytest.mark.parametrize("page_size", [0, 16])
def test_multi_token_decode_bit_identical_n1_vs_n8(setup, page_size):
    prompts = _mixed_workload(setup[0].vocab_size)
    streams = [_serve(_port(setup, decode_block=n, page_size=page_size),
                      Request, prompts) for n in (1, 8)]
    assert streams[0] == streams[1]


def test_paged_engine_bit_identical_to_dense(setup):
    prompts = _mixed_workload(setup[0].vocab_size, n=10, seed=5)
    dense = _serve(_port(setup, max_batch=4, decode_block=8), Request,
                   prompts)
    eng = _port(setup, max_batch=4, decode_block=8, page_size=16)
    assert _serve(eng, Request, prompts) == dense
    ps = eng.page_stats()
    assert ps["host_free"] == ps["pool_pages"] and ps["device_live"] == 0


def test_paged_continuous_admission_undersized_pool(setup):
    prompts = _mixed_workload(setup[0].vocab_size, n=10, seed=5)
    dense = _serve(_port(setup, max_batch=4, decode_block=8), Request,
                   prompts)
    eng = _port(setup, max_batch=4, decode_block=8, page_size=16,
                pool_pages=8)
    assert _serve(eng, Request, prompts) == dense
    assert eng.stats["admission_stalls"] > 0
    ps = eng.page_stats()
    assert ps["host_free"] == ps["pool_pages"] and ps["device_live"] == 0


def test_paged_prefix_sharing_refcounts_pages(setup):
    head = np.arange(32, dtype=np.int32)
    tails = [np.concatenate([head, np.full(4 + i, i, np.int32)])
             for i in range(4)]
    eng = _port(setup, max_batch=2, page_size=16, prefix_cache=4)
    got = _serve(eng, Request, tails, max_new=4, temps=False)
    dense = _serve(_port(setup, max_batch=2), Request, tails, max_new=4,
                   temps=False)
    assert got == dense
    assert eng.stats["prefix_stores"] >= 1
    assert eng.stats["prefix_hits"] >= 1
    assert eng.stats["pages_shared"] >= 2
    assert eng.page_stats()["device_live"] == 2 * eng.stats["prefix_stores"]


def test_submit_rejects_prompt_at_max_len(setup):
    eng = _port(setup, max_batch=1, max_len=32)
    for uid, n in ((0, 32), (1, 40)):
        with pytest.raises(ValueError, match="must be < max_len"):
            eng.submit(Request(uid=uid, prompt=np.zeros(n, np.int32),
                               max_new_tokens=1))
    eng.submit(Request(uid=2, prompt=np.zeros(31, np.int32),
                       max_new_tokens=4))
    done = eng.run()
    assert len(done) == 1 and len(done[0].generated) == 1  # row cap at 32


def test_prefill_bucket_edges(setup):
    def mk(min_bucket, max_len):
        return _port(setup, max_batch=1, max_len=max_len,
                     min_bucket=min_bucket)
    assert mk(16, 64).buckets() == [16, 32, 64]
    assert mk(16, 48).buckets() == [16, 32, 48]
    assert mk(128, 64).buckets() == [64]
    assert mk(16, 48)._bucket_for(17) == 32
    with pytest.raises(ValueError, match="exceeds max_len"):
        mk(16, 48)._bucket_for(49)


def test_eos_frees_slot(setup):
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


def test_host_syncs_amortized_over_decode_block(setup):
    eng = _port(setup, max_batch=2, decode_block=8)
    for uid in range(4):
        eng.submit(Request(uid=uid, prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=16))
    eng.run()
    assert eng.stats["tokens"] == 4 * 16
    assert eng.stats["host_syncs"] / eng.stats["tokens"] <= 0.25
