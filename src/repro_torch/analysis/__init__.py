"""The analytic roofline of the port: first-order FLOP and byte models per
architecture and step kind (`analytic.py`), and the three-term roofline
(`roofline.py`), each priced for a `ChipSpec` (`repro_torch.core.system`:
the H100 the port runs on is `H100_SXM`).  The compiled-artifact half of
the reference is `collectives.py` (the per-rank collective count of an
eager run, `hlo.py`'s schema, and the host-sync count beside it) and
`refresh.py` (the dry run's analytic blocks).  `lint/` is the port's
static analysis and budgets.

The names below are imported on first use, so that importing a
subpackage (the lint's AST layer) imports no torch."""
import importlib
import sys
import types

_EXPORTS = {
    "analytic_roofline": "analytic", "attention_flops": "analytic",
    "expected_collective_bytes": "analytic",
    "hbm_bytes_per_device": "analytic", "model_flops": "analytic",
    "useful_flops": "analytic", "RooflineTerms": "roofline",
    "roofline": "roofline",
}

__all__ = ["RooflineTerms", "analytic_roofline", "attention_flops",
           "expected_collective_bytes", "hbm_bytes_per_device",
           "model_flops", "roofline", "useful_flops"]


class _Package(types.ModuleType):
    """The import system binds each submodule on its package; the
    function `roofline` shares its module's name and stays the export."""

    def __setattr__(self, name, value):
        if name in _EXPORTS and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                    name)
    globals()[name] = value
    return value
