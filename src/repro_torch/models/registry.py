"""Architecture registry: --arch <id> -> (config, model functions).

Three families are ported so far: the transformer (of its configs, the
demo LM and the two MoE configs, granite-moe and qwen3-moe), the RG-LRU
hybrid (recurrentgemma-2b) and xLSTM (xlstm-350m)."""
from __future__ import annotations

import importlib
from dataclasses import replace
from types import SimpleNamespace

from .rglru import RGLRUConfig
from .transformer import TransformerConfig
from .xlstm import XLSTMConfig

ARCH_IDS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "xlstm-350m",
            "recurrentgemma-2b", "suncatcher-lm-100m"]

# config dataclass -> model module
_FAMILIES = {
    XLSTMConfig: "repro_torch.models.xlstm",
    RGLRUConfig: "repro_torch.models.rglru",
    TransformerConfig: "repro_torch.models.transformer",
}


def _config_module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def model_fns(cfg) -> SimpleNamespace:
    """Config dataclass -> the model module's interface: init / forward /
    loss_fn, the serving pair init_cache / decode_step, cast_params (the
    one compute-dtype copy the engine serves from) and decode_spec
    (models/decode_state.py), the per-slot state spec the engine uses."""
    for klass, modname in _FAMILIES.items():
        if isinstance(cfg, klass):
            mod = importlib.import_module(modname)
            break
    else:
        raise KeyError(f"no model family registered for config type "
                       f"{type(cfg).__name__}; registered families: "
                       f"{sorted(k.__name__ for k in _FAMILIES)}")
    from .decode_state import decode_spec
    return SimpleNamespace(init=mod.init_params, forward=mod.forward,
                           loss_fn=mod.loss_fn, init_cache=mod.init_cache,
                           decode_step=mod.decode_step,
                           cast_params=mod.cast_params,
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
