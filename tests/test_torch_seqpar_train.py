"""Training with sequence parallelism on "model" against the JAX
reference, on 8 gloo ranks (tests/_torch_mesh_worker.py, job "seqpar"):
the reduced minicpm-2b (6 heads, f32) from the reference's train state,
two AdamW steps on the reference's batches.

  - (2, 2, 2): the heads divide the 2-way model axis, so the attention
    is head-parallel while the residual stream, the per-layer
    checkpoints and the gradients' cotangents between blocks shard the
    sequence over "model" (Megatron-SP): the normed stream is gathered
    before the projections and the row-parallel outputs are
    reduce-scattered back;
  - (1, 2, 4): the 6 heads do not divide 4, so q keeps the sequence
    split and each rank's query rows run at their offset against K/V
    gathered whole (the reference's hint), forward and backward.

Losses and gradient norms within 1e-5 relative; the state after the
steps as tests/test_torch_training.py holds the unmeshed step (1e-5
relative, and lr / 30 absolute for the elements whose gradient is at
rounding level, where AdamW's first steps move by ~lr whatever the
gradient's size)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import init_train_state as j_init_train_state  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402

from _seqpar_common import flat, jax_model, run_worker  # noqa: E402

STEPS, B, S = 2, 8, 16


@pytest.fixture(scope="module")
def reference():
    cfg, fns = jax_model()
    state = j_init_train_state(jax.random.PRNGKey(0), cfg, fns)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
    inputs = {**flat(state, "s"), "tokens": tokens, "labels": labels}
    step = jax.jit(j_make_train_step(cfg, fns, JTrainConfig(
        adamw=JAdamW(lr=3e-3), warmup_steps=3, total_steps=50)))
    metrics = []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(tokens[i]),
                                "labels": jnp.asarray(labels[i])})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"inputs": inputs, "metrics": metrics, "state": flat(state, "s")}


@pytest.mark.parametrize("mesh", ["2,2,2", "1,2,4"])
def test_train_steps_on_the_sequence_parallel_layout(reference, tmp_path,
                                                     mesh):
    result, out = run_worker(tmp_path, 8, "train", mesh,
                             reference["inputs"])
    for got, want in zip(result["metrics"], reference["metrics"]):
        for k in ("loss", "grad_norm", "lr_scale"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    # the residual's sequence split: the MLP's row-parallel output is
    # reduce-scattered back onto it (and, head-parallel, the attention's)
    assert result["collectives"]["counts"].get("reduce-scatter", 0) > 0
    want = reference["state"]
    assert set(out) == set(want)
    for name, got in out.items():
        np.testing.assert_allclose(got, want[name], rtol=1e-5, atol=1e-4,
                                   err_msg=name)
        assert (np.abs(got - want[name]) > 1e-6).mean() <= 1e-3, name
