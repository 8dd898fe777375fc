"""Sequence parallelism on "model" against the JAX reference, on gloo
ranks (tests/_torch_mesh_worker.py, job "seqpar"), the reduced
minicpm-2b (6 heads, head_dim 12) at f32 with the reference's params
carried across:

  - decode with the KV cache's length sharded over "model", the
    reference dry run's layout, on a 2-way (2, 2) and a 4-way (1, 4)
    axis: a prefill of 6 tokens into the sharded cache, then 8 decode
    steps at positions 6-13, whose writes cross the slices' boundaries
    (8 on two ranks; 8 and 12 on four).  Each rank attends over its
    slice (B1 with its log-sum-exp; on the CPU its plain version) and
    the partials are merged.  Every step's logits and the final cache
    within 1e-5 of the reference's `decode_step`, and one f32 all-gather
    of (out, lse) per layer;
  - the forward with q sequence-sharded where the 6 heads do not divide
    the 4-way axis: each rank's query rows at their offset against the
    whole K/V, logits within 1e-5 of the reference's `forward`."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _seqpar_common import close, flat, jax_model, run_worker  # noqa: E402

PROMPT, T, B, MAX_LEN = 6, 14, 4, 16


@pytest.fixture(scope="module")
def reference():
    cfg, fns = jax_model()
    params = fns.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int64)
    step = jax.jit(lambda p, c, t: fns.decode_step(p, c, t, cfg))
    cache = fns.init_cache(cfg, B, MAX_LEN, pad_to=8)
    logits = []
    for t in [tokens[:, :PROMPT]] + [tokens[:, i:i + 1]
                                     for i in range(PROMPT, T)]:
        lg, cache = step(params, cache, jnp.asarray(t))
        logits.append(np.asarray(lg))
    fwd_tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int64)
    fwd = np.asarray(jax.jit(lambda p, t: fns.forward(p, t, cfg))(
        params, jnp.asarray(fwd_tokens)))
    return {"cfg": cfg, "params": flat(params, "p"), "tokens": tokens,
            "logits": logits, "cache": cache, "fwd_tokens": fwd_tokens,
            "fwd": fwd}


@pytest.mark.parametrize("mesh", ["2,2", "1,4"])
def test_decode_with_the_cache_length_sharded(reference, tmp_path, mesh):
    ref = reference
    ms = int(mesh.split(",")[1])
    result, out = run_worker(tmp_path, 4, "decode", mesh, {
        **ref["params"], "tokens": ref["tokens"],
        "prompt": np.array(PROMPT), "max_len": np.array(MAX_LEN)})
    assert result["cache_local_len"] == MAX_LEN // ms
    assert "Shard(dim=2)" in result["cache_placements"]
    for i, want in enumerate(ref["logits"]):
        close(out[f"logits{i}"], want)
    close(out["k"], ref["cache"]["k"])
    close(out["v"], ref["cache"]["v"])
    assert result["pos"] == T
    # a decode step's all-gathers, per layer: q, k and v whole on "model"
    # ((B / data) x 72 each), and the merge's (out, lse), (B / data) x 6
    # heads x (12 + 1) from each model rank, all f32
    cfg = ref["cfg"]
    rows = B // int(mesh.split(",")[0])
    qkv = 3 * rows * cfg.n_heads * cfg.hd * 4
    merge = ms * rows * cfg.n_heads * (cfg.hd + 1) * 4
    for coll in result["collectives"][1:]:
        assert coll["counts"]["all-gather"] == 4 * cfg.n_layers
        assert coll["bytes_by_dtype"]["all-gather"] == {
            "f32": cfg.n_layers * (qkv + merge)}


def test_forward_with_q_sequence_sharded(reference, tmp_path):
    ref = reference
    result, out = run_worker(tmp_path, 4, "prefill", "1,4", {
        **ref["params"], "tokens": ref["fwd_tokens"]})
    # one query split per layer: 6 heads do not divide 4 model ranks
    assert result["query_splits"] == ref["cfg"].n_layers
    close(out["logits"], ref["fwd"])
