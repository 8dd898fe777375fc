"""The port's analytic FLOP/byte model (`repro_torch.analysis.analytic`)
against the JAX package's, for every registered config x step kind.

Limit: equal (==).  Both evaluate the same Python float expressions in
the same order over configs whose counts (`param_count`,
`active_param_count`) and fields are the same integers, so every term is
the same double.  Priced at the reference's `ChipSpec()` and at a
reference `ChipSpec` built with `H100_SXM`'s figures.  The reference's
configs count their params by tracing their init (`jax.eval_shape`, ~0.1 s
a call), so each is counted once per arch here."""
import dataclasses
import functools

import pytest

pytest.importorskip("torch")

from repro.analysis import analytic as ja  # noqa: E402
from repro.core.system import ChipSpec as JChipSpec  # noqa: E402
from repro.models import registry as jr  # noqa: E402
from repro_torch.analysis import analytic as ta  # noqa: E402
from repro_torch.core import H100_SXM, ChipSpec  # noqa: E402
from repro_torch.models import registry as tr  # noqa: E402

KINDS = ("train", "prefill", "decode")
# (batch, seq, chips, data_shards, model_shards, microbatches)
SHAPES = ((8, 1024, 1, 1, 1, 1), (256, 4096, 256, 16, 16, 4),
          (128, 32768, 512, 32, 16, 1))
CHIPS = {"default": (ChipSpec(), JChipSpec()),
         "h100": (H100_SXM, JChipSpec(**dataclasses.asdict(H100_SXM)))}


@functools.lru_cache(maxsize=None)
def _jcfg(arch):
    """The reference's config of `arch`, its param counts taken once: an
    instance of a subclass of the same name (`_arch_dims` reads the type's
    name) whose count methods return the counted ints."""
    cfg = jr.get_config(arch)
    n, active = cfg.param_count(), cfg.active_param_count()
    klass = type(type(cfg).__name__, (type(cfg),),
                 {"param_count": lambda self: n,
                  "active_param_count": lambda self: active})
    return klass(**{f.name: getattr(cfg, f.name)
                    for f in dataclasses.fields(cfg)})


def test_arch_ids_equal():
    assert tr.ARCH_IDS == jr.ARCH_IDS


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", tr.ARCH_IDS)
def test_analytic_parts_equal(arch, kind):
    tc, jc = tr.get_config(arch), _jcfg(arch)
    assert ta._arch_dims(tc) == ja._arch_dims(jc)
    for b, s, _, ds, ms, mb in SHAPES:
        assert ta.attention_flops(tc, kind, b, s) == \
            ja.attention_flops(jc, kind, b, s)
        assert ta.model_flops(tc, kind, b, s) == ja.model_flops(jc, kind, b, s)
        assert ta.useful_flops(tc, kind, b, s) == \
            ja.useful_flops(jc, kind, b, s)
        kw = dict(data_shards=ds, model_shards=ms, microbatches=mb)
        assert ta.hbm_bytes_per_device(tc, kind, b, s, **kw) == \
            ja.hbm_bytes_per_device(jc, kind, b, s, **kw)
        assert ta.expected_collective_bytes(tc, kind, b, s, **kw) == \
            ja.expected_collective_bytes(jc, kind, b, s, **kw)


@pytest.mark.parametrize("chip", sorted(CHIPS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", tr.ARCH_IDS)
def test_analytic_roofline_equal(arch, kind, chip):
    tchip, jchip = CHIPS[chip]
    tc, jc = tr.get_config(arch), _jcfg(arch)
    for b, s, n, ds, ms, mb in SHAPES:
        kw = dict(chips=n, data_shards=ds, model_shards=ms,
                  wire_bytes_per_device=3.5e9, microbatches=mb)
        got = ta.analytic_roofline(tc, kind, b, s, chip=tchip, **kw)
        want = ja.analytic_roofline(jc, kind, b, s, chip=jchip, **kw)
        assert got == want
        assert 0.0 < got["mfu"] <= 1.0


def test_default_chip_is_the_references_default():
    cfg = tr.get_config("suncatcher-lm-100m")
    jcfg = _jcfg("suncatcher-lm-100m")
    kw = dict(chips=1, data_shards=1, model_shards=1)
    # the port's wire_bytes_per_device defaults to the reference's 0 case
    assert ta.analytic_roofline(cfg, "train", 8, 1024, **kw) == \
        ja.analytic_roofline(jcfg, "train", 8, 1024,
                             wire_bytes_per_device=0.0, **kw)
    h100 = ta.analytic_roofline(cfg, "train", 8, 1024, chip=H100_SXM, **kw)
    # the demo LM's step at phase 5's shape on one card is compute-bound
    assert h100["dominant"] == "compute"
    assert h100["model_flops"] == 6.0 * cfg.active_param_count() * 8 * 1024
