"""Registries that tell the port's lint *where* each invariant applies.

The AST layer is stdlib ``ast`` only (no torch import), so the lint CLI
runs in milliseconds.  Everything repo-specific lives here:

* ``DEVICE_BLOCK_ENTRY_POINTS`` — functions whose bodies run as one
  device block: the counterparts of the reference's jit entry points
  (`repro.analysis.lint.registry.JIT_ENTRY_POINTS`).  Eager PyTorch has
  no tracer to refuse a host read, so a block runs host-sync free only
  because nothing in it reads the device.  The linter also takes every
  call inside a ``with no_host_sync(...)`` body as a root, and checks
  the body itself.
* ``HOT_ENTRY_POINTS`` — host-side hot loops (decode/step/run loops).
  Each host sync here must be an intentional drain with an inline
  justification.
* ``REPLAY_SENSITIVE_MODULES`` — modules whose randomness must be a pure
  function of (seed, round/tick/request id) so chaos replay stays
  bit-exact.  PRNG rules (PR001/PR002) only fire inside these.
* ``STATE_SCOPED_MODULES`` — serving-plane modules that must stay
  family-agnostic: decode state is an abstract tree there
  (models/decode_state.py owns the layouts), so subscripting a
  family-layout key like ``["k"]`` or ``["rec_a"]`` (DS001) would
  re-couple the plane to one architecture.

Fixture escape hatch: a module under lint may declare its own
``LINT_HOT_ENTRY_POINTS = ["fn", ...]``,
``LINT_DEVICE_BLOCK_ENTRY_POINTS = ["fn", ...]``,
``LINT_REPLAY_SENSITIVE = True`` or ``LINT_STATE_SCOPED = True`` as a
module-level literal; the linter reads those from the AST, so test
fixtures exercise every scope without being imported.
"""

from __future__ import annotations

# Host-side hot loops: module -> function/method qualnames.  A host sync
# (HS00x) anywhere reachable from these is a finding unless suppressed.
HOT_ENTRY_POINTS: dict[str, tuple[str, ...]] = {
    "repro_torch.serving.engine": ("ServingEngine.step", "ServingEngine.run"),
    "repro_torch.serving.router": ("ConstellationRouter.step",
                                   "ConstellationRouter.run"),
    "repro_torch.train.fault_tolerance": (
        "FaultTolerantTrainer.run",
        "FaultTolerantTrainer.run_fused",
        "DiLoCoSupervisor.run",
    ),
}

# Device blocks: the functions that run with no host sync, the engine's
# seven jit roots in the reference, the DiLoCo round and outer step, and
# the trainer's fused K-step block.  Everything they reach is checked by
# the JT rules.
DEVICE_BLOCK_ENTRY_POINTS: dict[str, tuple[str, ...]] = {
    "repro_torch.serving.engine": (
        "ServingEngine._engine_step_impl",
        "ServingEngine._prefill_impl",
        "ServingEngine._export_impl",
        "ServingEngine._import_impl",
        "ServingEngine._delta_export_impl",
        "ServingEngine._standby_apply_impl",
        "ServingEngine._deactivate_impl",
    ),
    "repro_torch.train.diloco": ("make_diloco_round.round_fn", "outer_step"),
    "repro_torch.train.loop": ("make_fused_steps.fused",),
}

# Modules whose PRNG use must fold on a replay id (PR001/PR002 scope).
REPLAY_SENSITIVE_MODULES: tuple[str, ...] = (
    "repro_torch.core.isl.liveness",
    "repro_torch.serving.chaos",
    "repro_torch.train.diloco",
    "repro_torch.serving.engine",
    "repro_torch.serving.router",
)

# Serving-plane modules written against the DecodeState protocol: decode
# state there is an opaque tree handled through the generic row ops
# (models/decode_state.py), plus the protocol-level "pos" row and the
# engine's own sampler keys.
STATE_SCOPED_MODULES: tuple[str, ...] = (
    "repro_torch.serving.engine",
    "repro_torch.serving.router",
)

# Family-private decode-state leaf names (the transformer KV cache, the
# RG-LRU carry + local-attention ring, the xLSTM memories, the paged KV
# pool + page-table/allocator leaves): the reference's set, each of
# which models/decode_state.py uses as a key.  Only that module and the
# model modules may address these.
STATE_LAYOUT_KEYS: frozenset[str] = frozenset(
    {"k", "v", "rec_a", "rec_b", "attn", "tail", "slstm", "mlstm",
     "kp", "vp", "ptab", "free", "top", "ref", "pf_tab", "pf_len"}
)

# serving/prng.py's functions that consume randomness from a Threefry
# key (the reference's KEY_CONSUMERS, as the port names them).  A raw
# (never-folded) key reaching one of these, or the same key Name
# reaching two of them, is a PRNG-discipline finding.
KEY_CONSUMERS: frozenset[str] = frozenset(
    {"normal", "uniform", "bernoulli", "categorical", "gumbel", "randint",
     "truncated_normal", "permutation", "choice", "bits", "exponential",
     "poisson", "random_bits"}
)

# torch's global-generator draws: a call of one of these without
# `generator=` draws from process-wide state that no replay id keys
# (PR001).  `torch.manual_seed` reseeds that state.
GLOBAL_RNG_DRAWS: frozenset[str] = frozenset(
    {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
     "randint_like", "multinomial", "bernoulli", "normal", "poisson"}
)
GLOBAL_RNG_METHODS: frozenset[str] = frozenset(
    {"normal_", "uniform_", "bernoulli_", "exponential_", "geometric_",
     "cauchy_", "log_normal_", "random_"}
)
