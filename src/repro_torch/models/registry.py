"""Architecture registry: --arch <id> -> (config, model functions, shapes).

All eleven configs of the reference are registered, in its order: the
transformer family (dense, MoE, VLM and audio configs), the RG-LRU
hybrid (recurrentgemma-2b) and xLSTM (xlstm-350m)."""
from __future__ import annotations

import importlib
from dataclasses import replace
from types import SimpleNamespace

from .rglru import RGLRUConfig
from .transformer import TransformerConfig
from .xlstm import XLSTMConfig

ARCH_IDS = [
    "granite-moe-1b-a400m",
    "qwen3-moe-30b-a3b",
    "minicpm-2b",
    "stablelm-12b",
    "command-r-35b",
    "qwen2.5-32b",
    "qwen2-vl-2b",
    "xlstm-350m",
    "recurrentgemma-2b",
    "musicgen-medium",
    # the paper's own end-to-end demo model
    "suncatcher-lm-100m",
]

# The LM shape suite of the dry run: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# Sub-quadratic archs run long_500k; pure full-attention archs skip it.
SUBQUADRATIC = {"xlstm-350m", "recurrentgemma-2b"}

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
    one compute-dtype copy the engine serves from), params_from_jax (the
    reference's params, exported with `np.asarray`, as port tensors) and
    decode_spec (models/decode_state.py), the per-slot state spec the
    engine uses."""
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
                           params_from_jax=mod.params_from_jax,
                           decode_spec=decode_spec)


def get_config(arch: str, **overrides):
    cfg = _config_module(arch).config()
    return replace(cfg, **overrides) if overrides else cfg


def get_reduced_config(arch: str, **overrides):
    """Tiny same-family config for CPU tests."""
    cfg = _config_module(arch).reduced()
    return replace(cfg, **overrides) if overrides else cfg


def input_kind(arch: str) -> str:
    """What a batch of this arch holds (the data pipeline's
    `DataConfig.kind`): "tokens", "codebooks" (B, n_q, S) or "vlm" (tokens
    plus (3, B, S) M-RoPE positions)."""
    return getattr(_config_module(arch), "INPUT_KIND", "tokens")


def lr_schedule(arch: str) -> str:
    """The arch's default LR schedule: "wsd" where its config names it
    (minicpm-2b, as the reference's launcher picks), else "cosine"."""
    return getattr(_config_module(arch), "LR_SCHEDULE", "cosine")


def shape_applicable(arch: str, shape: str) -> bool:
    """long_500k runs only on the sub-quadratic archs (a quadratic KV
    cache at 524k tokens is skipped, as in the reference)."""
    return shape != "long_500k" or arch in SUBQUADRATIC


def cells(archs=None):
    """Every runnable (arch, shape) dry-run cell; by default all archs but
    the demo LM, in ARCH_IDS order."""
    archs = archs or [a for a in ARCH_IDS if a != "suncatcher-lm-100m"]
    return [(a, s) for a in archs for s in SHAPES if shape_applicable(a, s)]
