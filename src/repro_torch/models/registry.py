"""Architecture registry: --arch <id> -> (config, model functions).

Only the transformer family is ported so far, and of its configs only the
demo LM."""
from __future__ import annotations

import importlib
from dataclasses import replace
from types import SimpleNamespace

from .transformer import TransformerConfig

ARCH_IDS = ["suncatcher-lm-100m"]


def _config_module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def model_fns(cfg) -> SimpleNamespace:
    """Config dataclass -> the model module's interface: init / forward /
    loss_fn, the serving pair init_cache / decode_step, and decode_spec
    (models/decode_state.py), the per-slot state spec the engine uses."""
    if not isinstance(cfg, TransformerConfig):
        raise KeyError(f"no model family registered for config type "
                       f"{type(cfg).__name__}; ported: TransformerConfig")
    from . import transformer as mod
    from .decode_state import decode_spec
    return SimpleNamespace(init=mod.init_params, forward=mod.forward,
                           loss_fn=mod.loss_fn, init_cache=mod.init_cache,
                           decode_step=mod.decode_step,
                           decode_spec=decode_spec)


def get_config(arch: str, **overrides):
    cfg = _config_module(arch).config()
    return replace(cfg, **overrides) if overrides else cfg


def get_reduced_config(arch: str, **overrides):
    """Tiny same-family config for CPU tests."""
    cfg = _config_module(arch).reduced()
    return replace(cfg, **overrides) if overrides else cfg


def input_kind(arch: str) -> str:
    """What a batch of this arch holds: "tokens" (the data pipeline's
    `DataConfig.kind`)."""
    return getattr(_config_module(arch), "INPUT_KIND", "tokens")
