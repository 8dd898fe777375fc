"""Training the MoE, xLSTM and RG-LRU families in the port against the
JAX package: granite-moe-1b-a400m and qwen3-moe-30b-a3b (top-k routing,
the sort-based slot table, index gathers in the backward), xlstm-350m
(the sLSTM loop; the mLSTM's prefix sums through the RG-LRU scan at
a = 1, in its parallel and chunked forms) and recurrentgemma-2b (the
RG-LRU scan's backward, remat'd groups and plain tail blocks).  Reduced
configs at f32 compute; the same params and train state, carried across
through numpy (`params_from_jax`, `train_state_from_jax`); the same
batches (the reference's SyntheticLM).

Tolerances, f32 on both sides with sums in other orders:
  - the loss and its gradients: 1e-5 relative for the loss, and each
    gradient leaf within 1e-5 relative plus 1e-5 of the leaf's largest
    |gradient| (as tests/test_torch_training.py holds the dense
    transformer); XLSTM_GRAD for xLSTM, whose prefix sums the port adds
    in order in f32 where `jnp.cumsum` runs XLA's own order, and whose
    exponential gates amplify the difference;
  - eight train steps: loss, grad norm and lr scale within 1e-5 relative
    (xLSTM: XLSTM_GRAD), the final state at rtol 1e-5 / atol 1e-4 with
    at most 1 in 1000 elements of each leaf off by more than 1e-6, as
    tests/test_torch_training.py::test_eight_train_steps_match_jax holds
    the dense transformer (AdamW moves an element whose gradient sits at
    rounding level by ~lr whatever its sign).  xLSTM's gradients agree
    to 1e-4, not 1e-5, so more of its elements take such a step: its
    state is held at atol XLSTM_STATE (a third of one step at lr 3e-3)
    with at most 1 in 100 elements of the whole state off by more than
    1e-6 (measured: the sLSTM gate biases up to 1.1e-4 off in a quarter
    of their entries, the weight matrices in 0.1-0.3% of theirs).
    No routing choice flips between the packages in these eight steps
    (granite-moe's state agrees like the dense transformer's)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import DataConfig as JDataConfig  # noqa: E402
from repro.train import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import init_train_state as j_init_train_state  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import (AdamWConfig, TrainConfig,  # noqa: E402
                               make_train_step, train_state_from_jax)
from repro_torch.train.tree import (tree_leaves, tree_map,  # noqa: E402
                                    tree_paths)

torch.set_num_threads(1)

TOL = 1e-5
XLSTM_GRAD = 1e-4
XLSTM_STATE = 1e-3
TRAIN_ARCHS = ["granite-moe-1b-a400m", "xlstm-350m", "recurrentgemma-2b"]


def _jflat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tbatch(jbatch):
    return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


_SETUPS = {}


def _setup(arch, **over):
    """Both packages' reduced config at f32 compute, the JAX train state
    and the port's copy of it, the reference's data stream."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _SETUPS:
        jcfg = jreg.get_reduced_config(arch, compute_dtype="float32", **over)
        tcfg = treg.get_reduced_config(arch, compute_dtype="float32", **over)
        jfns, tfns = jreg.model_fns(jcfg), treg.model_fns(tcfg)
        jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg, jfns)
        tstate = train_state_from_jax(
            jax.tree.map(np.asarray, jstate), tcfg, "cpu")
        data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size,
                                        seq_len=32, global_batch=4))
        _SETUPS[key] = jcfg, tcfg, jfns, tfns, jstate, tstate, data
    return _SETUPS[key]


@pytest.mark.parametrize("arch,over", [
    ("granite-moe-1b-a400m", {}),
    ("qwen3-moe-30b-a3b", {}),
    ("xlstm-350m", {}),                     # seq 32: the parallel form
    ("xlstm-350m", {"mlstm_chunk": 16}),    # two chunks: the chunked form
    ("recurrentgemma-2b", {}),
])
def test_loss_gradients_match_jax_grad(arch, over):
    """`loss_fn` and every gradient leaf through remat against
    `jax.value_and_grad` of the reference's loss on the same batch."""
    jcfg, tcfg, jfns, tfns, jstate, tstate, data = _setup(arch, **over)
    batch = data.batch_at(3)
    jl, jg = jax.value_and_grad(jfns.loss_fn)(jstate["params"], batch, jcfg)
    params = tree_map(lambda p: p.detach().requires_grad_(),
                      tstate["params"])
    tl = tfns.loss_fn(params, _tbatch(batch), tcfg)
    grads = torch.autograd.grad(tl, tree_leaves(params))
    tol = XLSTM_GRAD if arch == "xlstm-350m" else TOL
    assert tl.item() == pytest.approx(float(jl), rel=tol)
    jflat = _jflat(jg)
    assert set(jflat) == set(tree_paths(params))
    for name, g in zip(tree_paths(params), grads):
        want = jflat[name]
        np.testing.assert_allclose(g.numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_eight_train_steps_match_jax(arch):
    """make_train_step from the JAX state carried across, fed the
    reference's batches, against the reference's jitted step."""
    jcfg, tcfg, jfns, tfns, jstate, tstate, data = _setup(arch)
    kw = dict(warmup_steps=3, total_steps=50)
    jstep = jax.jit(j_make_train_step(jcfg, jfns, JTrainConfig(
        adamw=JAdamW(lr=3e-3), **kw)))
    tstep = make_train_step(tcfg, tfns, TrainConfig(
        adamw=AdamWConfig(lr=3e-3), **kw))
    tol = XLSTM_GRAD if arch == "xlstm-350m" else TOL
    for s in range(8):
        batch = data.batch_at(s)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _tbatch(batch))
        for k in ("loss", "grad_norm", "lr_scale"):
            assert tm[k].item() == pytest.approx(float(jm[k]), rel=tol), \
                (s, k)
    assert int(tstate["step"]) == int(jstate["step"]) == 8
    jflat = _jflat(jstate)
    off = total = 0
    for name, got in tree_paths(tstate).items():
        got = got.numpy()
        np.testing.assert_allclose(
            got, jflat[name], rtol=1e-5,
            atol=XLSTM_STATE if arch == "xlstm-350m" else 1e-4, err_msg=name)
        far = np.abs(got - jflat[name]) > 1e-6
        off, total = off + int(far.sum()), total + far.size
        if arch != "xlstm-350m":
            assert far.mean() <= 1e-3, name
    assert off / total <= (1e-2 if arch == "xlstm-350m" else 1e-3)
