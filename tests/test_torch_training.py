"""The port's training modules against the JAX package (same params and
state carried across through numpy, same batches, f32 compute), and the
port's own loop and data invariants, mirroring tests/test_training.py's
TestTrainLoop and TestData.  The launcher's CLI runs on the CPU when
asked to and refuses the default card without one."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import losses as jlosses  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import DataConfig as JDataConfig  # noqa: E402
from repro.train import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import init_train_state as j_init_train_state  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import schedule as jsched  # noqa: E402
from repro_torch.models import losses as tlosses  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig, DataConfig, SyntheticLM, TrainConfig, adamw_update,
    clip_by_global_norm, init_opt_state, init_train_state, make_eval_step,
    make_train_step, train_state_from_jax, warmup_cosine, wsd)
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train.tree import tree_leaves, tree_map, tree_paths  # noqa: E402,E501

torch.set_num_threads(1)

ARCH = "suncatcher-lm-100m"
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _tbatch(jbatch):
    return {k: _t(v) for k, v in jbatch.items()}


def _flat(tree):
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in tree_paths(tree).items()}


def _jflat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def both():
    """The reduced demo config at f32 compute in both packages, the JAX
    train state and the port's copy of it, JAX's data stream."""
    jcfg = jreg.get_reduced_config(ARCH, compute_dtype="float32")
    tcfg = treg.get_reduced_config(ARCH, compute_dtype="float32")
    jfns, tfns = jreg.model_fns(jcfg), treg.model_fns(tcfg)
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg, jfns)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                                  "cpu")
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                    global_batch=8))
    return jcfg, tcfg, jfns, tfns, jstate, tstate, data


def _tiny_setup(seed=0, lr=3e-3):
    """The port's counterpart of tests/test_training.py::_tiny_setup
    (the reduced config, bf16 compute, f32 masters)."""
    cfg = treg.get_reduced_config(ARCH)
    fns = treg.model_fns(cfg)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=lr), warmup_steps=5,
                       total_steps=200)
    state = init_train_state(torch.Generator().manual_seed(seed), cfg, fns,
                             "cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=seed), "cpu")
    return cfg, fns, state, data, make_train_step(cfg, fns, tcfg)


# ------------------------------------------------- parity with the JAX ----

@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_loss_and_grads_match_jax(both, loss_chunk):
    """loss_fn and its gradients at f32 compute, through remat (and the
    chunked xent): 1e-5 relative (f32 sums in another order)."""
    jcfg, tcfg, jfns, tfns, jstate, tstate, data = both
    jcfg = jreg.get_reduced_config(ARCH, compute_dtype="float32",
                                   loss_chunk=loss_chunk)
    tcfg = treg.get_reduced_config(ARCH, compute_dtype="float32",
                                   loss_chunk=loss_chunk)
    batch = data.batch_at(3)
    jl, jg = jax.value_and_grad(jfns.loss_fn)(jstate["params"], batch, jcfg)
    params = tree_map(lambda p: p.detach().requires_grad_(),
                      tstate["params"])
    tl = tfns.loss_fn(params, _tbatch(batch), tcfg)
    grads = torch.autograd.grad(tl, tree_leaves(params))
    assert tl.item() == pytest.approx(float(jl), rel=1e-5)
    jflat = _jflat(jg)
    for name, g in zip(tree_paths(params), grads):
        want = jflat[name]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_chunked_lm_loss_matches_jax_and_the_plain_loss():
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((2, 16, 32), np.float32)
    head = rng.standard_normal((32, 64), np.float32) * 0.3
    labels = rng.integers(0, 64, (2, 16)).astype(np.int32)
    want = jlosses.chunked_lm_loss(hidden, head, labels, chunk=4,
                                   logit_scale=0.5)
    got = tlosses.chunked_lm_loss(_t(hidden), _t(head), _t(labels),
                                  chunk=4, logit_scale=0.5)
    plain = tlosses.softmax_xent((_t(hidden) @ _t(head)) * 0.5,
                                 _t(labels)).mean()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    assert got.item() == pytest.approx(plain.item(), rel=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        tlosses.chunked_lm_loss(_t(hidden), _t(head), _t(labels), chunk=5)


def test_optimizer_and_schedules_match_jax():
    """adamw_update (two steps, weight decay on matrices only),
    clip_by_global_norm and both schedules: 1e-6."""
    rng = np.random.default_rng(1)
    params = {"layers": {"w": rng.standard_normal((3, 4, 5), np.float32)},
              "b": rng.standard_normal((5,), np.float32)}
    grads = [{"layers": {"w": rng.standard_normal((3, 4, 5), np.float32)},
              "b": rng.standard_normal((5,), np.float32) * 3}
             for _ in range(2)]
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jp, jst = params, jopt.init_opt_state(params)
    tp = tree_map(_t, params)
    tst = init_opt_state(tp)
    for g in grads:
        jg, jn = jopt.clip_by_global_norm(g, 1.0)
        tg, tn = clip_by_global_norm(tree_map(_t, g), 1.0)
        assert tn.item() == pytest.approx(float(jn), rel=1e-6)
        jp, jst = jopt.adamw_update(jp, jg, jst, JAdamW(**cfg), 0.5)
        tp, tst = adamw_update(tp, tg, tst, AdamWConfig(**cfg),
                               torch.tensor(0.5))
        for name, want in _jflat(jp).items():
            np.testing.assert_allclose(_flat(tp)[name], want, rtol=1e-6,
                                       atol=1e-6)
        for name, want in _jflat(jst["v"]).items():
            np.testing.assert_allclose(_flat(tst["v"])[name], want,
                                       rtol=1e-6, atol=1e-9)
    assert int(tst["step"]) == 2
    for step in (0, 3, 10, 55, 90, 100, 120):
        for jf, tf in ((jsched.warmup_cosine, warmup_cosine),
                       (jsched.wsd, wsd)):
            got = tf(torch.tensor(step, dtype=torch.int32), warmup=10,
                     total=100)
            assert got.dtype == torch.float32
            assert got.item() == pytest.approx(
                float(jf(step, warmup=10, total=100)), rel=1e-6, abs=1e-7)


def test_eight_train_steps_match_jax(both):
    """make_train_step from the JAX state carried across, fed JAX's
    batches.  Losses, grad norms and lr scales within 1e-5 relative.
    Params: AdamW moves every element by ~lr / step whatever its
    gradient's size, so an element whose gradient is at rounding level
    (embedding rows of tokens absent from a batch, reached only through
    the tied head) may take a different step: such elements get lr / 30
    (1e-4) of absolute slack, and at most 1 in 1000 of them may differ by
    more than 1e-6 (measured: 3 of 32768 embedding entries, none
    elsewhere)."""
    jcfg, tcfg, jfns, tfns, jstate, tstate, data = both
    kw = dict(warmup_steps=3, total_steps=50)
    jstep = jax.jit(j_make_train_step(jcfg, jfns, JTrainConfig(
        adamw=JAdamW(lr=3e-3), **kw)))
    tstep = make_train_step(tcfg, tfns, TrainConfig(
        adamw=AdamWConfig(lr=3e-3), **kw))
    for s in range(8):
        batch = data.batch_at(s)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _tbatch(batch))
        for k in ("loss", "grad_norm", "lr_scale"):
            assert tm[k].item() == pytest.approx(float(jm[k]), rel=1e-5), k
    assert int(tstate["step"]) == int(jstate["step"]) == 8
    jflat = _jflat(jstate)
    for name, got in _flat(tstate).items():
        np.testing.assert_allclose(got, jflat[name], rtol=1e-5, atol=1e-4,
                                   err_msg=name)
        assert (np.abs(got - jflat[name]) > 1e-6).mean() <= 1e-3, name


def test_train_state_from_jax_carries_a_mid_run_state(both):
    jcfg, tcfg, jfns, _, jstate, _, data = both
    jstep = jax.jit(j_make_train_step(jcfg, jfns, JTrainConfig()))
    for s in range(2):
        jstate, _ = jstep(jstate, data.batch_at(s))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                                  "cpu")
    jflat = _jflat(jstate)
    assert set(_flat(tstate)) == set(jflat)
    for name, got in _flat(tstate).items():
        np.testing.assert_array_equal(got, jflat[name])
    assert tstate["opt"]["step"].dtype == torch.int32


# ------------------------------------------------ the port's own loop ----

def test_loss_decreases():
    _, _, state, data, step = _tiny_setup()
    losses = []
    for s in range(30):
        state, m = step(state, data.batch_at(s))
        losses.append(m["loss"].item())
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5])


def test_microbatching_matches_full_batch(both):
    """Two microbatches of 4 against one batch of 8, f32: the mean of the
    halves' losses and gradients is the full batch's within f32
    rounding."""
    _, tcfg, _, tfns, _, tstate, data = both
    batch = _tbatch(data.batch_at(0))
    s1, m1 = make_train_step(tcfg, tfns, TrainConfig())(tstate, batch)
    s2, m2 = make_train_step(tcfg, tfns, TrainConfig(microbatches=2))(
        tstate, batch)
    assert m2["loss"].item() == pytest.approx(m1["loss"].item(), rel=1e-6)
    assert m2["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(),
                                                   rel=1e-5)
    for name, got in _flat(s2).items():
        np.testing.assert_allclose(got, _flat(s1)[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_train_step_leaves_its_input_state_untouched():
    _, _, state, data, step = _tiny_setup()
    before = {k: v.clone() for k, v in tree_paths(state).items()}
    step(state, data.batch_at(0))
    for k, v in tree_paths(state).items():
        assert torch.equal(v, before[k]), k


def test_eval_step_is_the_loss_without_gradients():
    cfg, fns, state, data, _ = _tiny_setup()
    batch = data.batch_at(0)
    got = make_eval_step(cfg, fns)(state, batch)
    assert not got.requires_grad
    assert got.item() == pytest.approx(
        fns.loss_fn(state["params"], batch, cfg).item(), rel=1e-6)


# ----------------------------------------------------------------- data --

def test_data_deterministic_replay_and_steps_differ():
    data = SyntheticLM(DataConfig(seed=7), "cpu")
    assert torch.equal(data.batch_at(123)["tokens"],
                       data.batch_at(123)["tokens"])
    assert not torch.equal(data.batch_at(0)["tokens"],
                           data.batch_at(1)["tokens"])


def test_labels_are_shifted_tokens():
    b = SyntheticLM(DataConfig(), "cpu").batch_at(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].dtype == torch.int32


def test_batch_block_is_stacked_batch_at():
    data = SyntheticLM(DataConfig(seed=3), "cpu")
    block = data.batch_block(np.arange(5, 9))
    for i in range(4):
        for k in ("tokens", "labels"):
            assert torch.equal(block[k][i], data.batch_at(5 + i)[k])


@pytest.mark.parametrize("vocab", [512, 32768])
def test_data_matches_jax_stream_exactly(vocab):
    """Keys, uniforms, the repetition pattern and the Zipf cdf are the
    reference's bit for bit, so every token of four steps is."""
    cfg = dict(vocab_size=vocab, seq_len=128, global_batch=8, seed=0)
    tdata_ = SyntheticLM(DataConfig(**cfg), "cpu")
    # the reference stream as jax draws it by default: other test modules
    # turn on jax_enable_x64 process-wide, which makes its draws 64-bit
    with jax.enable_x64(False):
        jdata = JSyntheticLM(JDataConfig(**cfg))
        wants = [np.asarray(jdata.batch_at(step)["tokens"])
                 for step in range(4)]
    for step, want in enumerate(wants):
        np.testing.assert_array_equal(
            tdata_.batch_at(step)["tokens"].numpy(), want)


@pytest.mark.parametrize("vocab", [7, 100, 1024, 32768, 50257, 256000])
def test_zipf_cdf_is_jnp_cumsum_bitwise(vocab):
    """`_zipf_cdf` against the cdf `jax.random.choice` searches: the
    `jnp.cumsum` of the reference's float32 probabilities, bit for bit.
    This pins XLA's association, so a jax whose cumsum sums in another
    order fails here."""
    from repro.train.data import _zipf_probs as j_zipf_probs
    with jax.enable_x64(False):
        want = np.asarray(jnp.cumsum(jnp.asarray(j_zipf_probs(vocab))))
    got = tdata._zipf_cdf(vocab)
    assert want.dtype == got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_pod_step_grid_is_the_reference_grid():
    from repro.train.data import pod_step_grid as j_grid
    np.testing.assert_array_equal(tdata.pod_step_grid(3, 2, 4),
                                  j_grid(3, 2, 4))


# ------------------------------------------------------------------ CLI --

def _train_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)


def test_train_cli_runs_on_cpu_when_asked():
    proc = _train_cli("--device", "cpu", "--steps", "4")
    assert proc.returncode == 0, proc.stderr
    assert "4 steps [fused drains (K=8)]" in proc.stdout
    assert "flash-attention kernel launches 0" in proc.stdout


def test_train_cli_default_device_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    proc = _train_cli("--steps", "4")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "Traceback" not in proc.stderr


def test_train_cli_refuses_unported_flags():
    """--mesh is still refused (ROADMAP A3b); --sdc-rate-multiplier is
    ported: at 2e3 the per-step loop detects, rolls back and finishes, at
    1e5 a persistent non-finite loss raises instead of livelocking, as the
    reference launcher does."""
    proc = _train_cli("--device", "cpu", "--mesh", "2")
    assert proc.returncode != 0
    assert "unrecognized arguments: --mesh" in proc.stderr
    proc = _train_cli("--device", "cpu", "--steps", "3",
                      "--sdc-rate-multiplier", "2e3")
    assert proc.returncode == 0, proc.stderr
    assert "[per-step host loop]" in proc.stdout
    stats = re.search(r"'sdc_injected': (\d+)", proc.stdout)
    assert stats and int(stats[1]) > 0
    proc = _train_cli("--device", "cpu", "--steps", "3",
                      "--sdc-rate-multiplier", "1e5")
    assert proc.returncode != 0
    assert "RuntimeError: persistent non-finite" in proc.stderr


@pytest.mark.parametrize("args", [
    ("--steps", "2"),
    ("--diloco-pods", "2", "--inner-steps", "2", "--steps", "2")])
def test_train_cli_error_is_not_hidden_by_its_checkpoint_writers(
        monkeypatch, args):
    """A run that fails while a checkpoint is still being written raises
    its own error: the writer finishes before the launcher removes its
    checkpoint directory, so no FileNotFoundError follows from it."""
    import threading
    import time

    from repro_torch.launch import train as launch
    from repro_torch.train import checkpoint, fault_tolerance

    savez = checkpoint.np.savez

    def slow_savez(*a, **k):      # the writer is mid-checkpoint here
        time.sleep(0.3)
        return savez(*a, **k)

    def fail(self, *a, **k):
        if isinstance(self, fault_tolerance.FaultTolerantTrainer):
            self._save_checkpoint(0)
        raise RuntimeError("the run's own error")

    writer_errors = []
    monkeypatch.setattr(checkpoint.np, "savez", slow_savez)
    monkeypatch.setattr(threading, "excepthook", writer_errors.append)
    for cls, name in ((fault_tolerance.FaultTolerantTrainer, "run"),
                      (fault_tolerance.FaultTolerantTrainer, "run_fused"),
                      (fault_tolerance.DiLoCoSupervisor, "run")):
        monkeypatch.setattr(cls, name, fail)
    with pytest.raises(RuntimeError, match="the run's own error"):
        launch.main(["--device", "cpu", *args])
    for t in threading.enumerate():
        if t.name.endswith("(save)"):
            t.join()
    assert writer_errors == []
