"""AST rule implementations for the port's eager PyTorch hot paths.

Rule catalog (rendered by ``--list-rules``):

Device-block scope (code that runs with no host sync: the registry's
device-block entry points, the bodies of ``with no_host_sync(...)`` and
everything reachable from them):
  JT001  .item()                               — a device read per call
  JT002  float()/int()/bool() of a tensor
  JT003  np.asarray/np.array of a tensor, or .numpy()
  JT004  .cpu(), .tolist() or .to("cpu")       — the device_get counterpart
  JT005  torch.cuda.synchronize, or Event/Stream .synchronize()
  JT006  Python if/while on a tensor value     — (`is None` checks exempt)
  JT007  an op whose output shape depends on data (nonzero, boolean-mask
         indexing, masked_select, unique, repeat_interleave without
         output_size, one-argument torch.where): a silent sync in eager CUDA
  RT003  f-string/str()/repr()/print of a tensor — reads it to the host

Hot host scope (decode/step/run loops from the registry):
  HS001  .cpu(), .numpy(), .tolist() or .to("cpu") in a hot loop
  HS002  torch.cuda.synchronize or .synchronize() in a hot loop
  HS003  .item(), or int()/float()/bool() of a tensor, in a hot loop

Replay-sensitive modules:
  PR001  randomness not keyed by a replay id: a Threefry key
         (serving/prng.py) consumed without fold_in, np.random.default_rng
         or Generator.manual_seed with a constant seed, or a draw from
         torch's global generator (no generator=), or torch.manual_seed
  PR002  same key consumed twice without reassignment

State-scoped modules (the serving plane; DecodeState protocol):
  DS001  family-layout decode-state key subscripted outside the family
         boundary

Budgets (``--budgets``, budgets.py):
  BG001  host syncs in a device entry point (dispatch count; on the card
         also sync debug mode)
  BG002  pod-axis collective bytes over budget
  BG003  compiled variants (input signatures) over budget

Meta:
  LN001  suppression comment without justification
  LN002  inline allow not mirrored in baseline.txt (or stale baseline entry)

Every rule of the reference's catalog (`repro.analysis.lint.rules`) is
here under its ID or in ``NO_COUNTERPART`` with the reason.
"""

from __future__ import annotations

import ast
import re

from .callgraph import (FuncInfo, ModuleInfo, Project, dotted, is_guard,
                        own_nodes)
from .findings import Finding
from .registry import (GLOBAL_RNG_DRAWS, GLOBAL_RNG_METHODS, KEY_CONSUMERS,
                       REPLAY_SENSITIVE_MODULES, STATE_LAYOUT_KEYS,
                       STATE_SCOPED_MODULES)

RULE_CATALOG: dict[str, str] = {
    "JT001": ".item() inside a device block",
    "JT002": "float()/int()/bool() of a tensor inside a device block",
    "JT003": "np.asarray/np.array of a tensor, or .numpy(), inside a device block",
    "JT004": ".cpu()/.tolist()/.to('cpu') inside a device block",
    "JT005": "torch.cuda.synchronize or .synchronize() inside a device block",
    "JT006": "Python if/while branching on a tensor value",
    "JT007": "data-dependent output shape (nonzero, mask indexing, unique, ...) inside a device block",
    "RT003": "f-string/str()/repr()/print of a tensor inside a device block",
    "HS001": ".cpu()/.numpy()/.tolist()/.to('cpu') in a host hot loop",
    "HS002": "torch.cuda.synchronize or .synchronize() in a host hot loop",
    "HS003": ".item() or int()/float()/bool() of a tensor in a host hot loop",
    "PR001": "randomness not keyed by a replay id",
    "PR002": "PRNG key consumed twice",
    "DS001": "family-layout decode-state access in a state-scoped module",
    "BG001": "host syncs in a device entry point",
    "BG002": "pod-axis collective-byte budget exceeded",
    "BG003": "compiled-variant budget exceeded",
    "LN001": "suppression without justification",
    "LN002": "suppression/baseline mismatch",
}

# The reference's rules that eager PyTorch cannot break, each with why.
NO_COUNTERPART: dict[str, str] = {
    "RT001": "eager PyTorch does not trace: a Python branch on a shape runs "
             "once per call and compiles nothing, so there is no retrace; "
             "the variety of input shapes is counted by BG003 instead",
    "RT002": "there is no static_argnums: a module is not compiled per "
             "hashable argument, so an unhashable literal costs nothing",
    "DN001": "there is no buffer donation: a tensor passed to a function "
             "stays valid after the call",
}

# Annotations that mark a parameter as static config, not a tensor.
_STATIC_ANN = re.compile(r"\b(int|float|bool|str|bytes|Config|Mesh|Sharding|Path)\b")


# parameter names that hold configuration, not tensors
_STATIC_NAME = re.compile(r"^(\w*cfg|mesh|spec|specs|axes|shape|shapes|sizes)$")


def _ann_is_static(ann: ast.expr | None) -> bool:
    if ann is None:
        return False
    try:
        text = ast.unparse(ann)
    except Exception:
        return False
    return bool(_STATIC_ANN.search(text))


# attributes that read a tensor's metadata, never its values
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "type",
                "placements", "device_mesh", "layout", "requires_grad"}
_SHAPE_CALLS = {"len", "size", "dim", "numel"}
# calls whose result is a boolean mask
_MASK_CALLS = {"isfinite", "isnan", "isinf", "logical_and", "logical_or",
               "logical_not", "logical_xor", "bool", "eq", "ne", "lt", "le",
               "gt", "ge"}


def _shape_names(sub: ast.AST) -> list[ast.Name]:
    """Names read only for their metadata under `sub`: x in x.shape,
    x.ndim, x.dtype, len(x), x.size(...), x.dim(), x.numel()."""
    if isinstance(sub, ast.Attribute) and sub.attr in _SHAPE_ATTRS:
        return [n for n in ast.walk(sub.value) if isinstance(n, ast.Name)]
    if isinstance(sub, ast.Call):
        if dotted(sub.func) == "len" and sub.args:
            return [n for n in ast.walk(sub.args[0]) if isinstance(n, ast.Name)]
        if isinstance(sub.func, ast.Attribute) and sub.func.attr in _SHAPE_CALLS:
            return [n for n in ast.walk(sub.func.value) if isinstance(n, ast.Name)]
    return []


class Taint:
    """Flow-insensitive value/shape taint for one device-block function
    (the reference's), plus a mask taint: names that hold a boolean
    tensor (a comparison, ~/&/| of masks, isfinite, .bool())."""

    def __init__(self, fn: FuncInfo, extra: set[str] = frozenset()):
        self.value: set[str] = set(extra)
        self.shape: set[str] = set()
        self.mask: set[str] = set()
        args = fn.node.args
        params = list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        for a in params:
            if a.arg in ("self", "cls"):
                continue
            if _ann_is_static(a.annotation) or _STATIC_NAME.match(a.arg):
                continue
            self.value.add(a.arg)
        if args.vararg:
            self.value.add(args.vararg.arg)
        # a lambda's parameters (its body counts as this function's)
        for lam in own_nodes(fn.node):
            if isinstance(lam, ast.Lambda):
                self.value |= {a.arg for a in lam.args.args + lam.args.posonlyargs
                               if not _STATIC_NAME.match(a.arg)}
        self._fixpoint(fn.node)

    def expr_taint(self, node: ast.expr) -> tuple[bool, bool]:
        """(value_tainted, shape_tainted) for an expression.

        Name occurrences under ``.shape/.ndim/.dtype`` or ``len()``
        contribute *shape* taint only — ``int(x.shape[0] * frac)`` is a
        host computation, not a device read."""
        under_shape: set[int] = set()
        shp = False
        for sub in ast.walk(node):
            for n in _shape_names(sub):
                under_shape.add(id(n))
                if n.id in self.value or n.id in self.shape:
                    shp = True
        val = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and id(sub) not in under_shape:
                if sub.id in self.value:
                    val = True
                elif sub.id in self.shape:
                    shp = True
        return (val, shp)

    def is_mask(self, node: ast.expr) -> bool:
        """True for an expression that holds a boolean tensor."""
        if isinstance(node, ast.Name):
            return node.id in self.mask
        if isinstance(node, ast.Compare):
            return self.expr_taint(node)[0]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.Invert, ast.Not)):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Call):
            tail = dotted(node.func).split(".")[-1] if dotted(node.func) else (
                node.func.attr if isinstance(node.func, ast.Attribute) else "")
            if tail in _MASK_CALLS:
                return self.expr_taint(node)[0]
            if tail == "to" and any(dotted(a) == "torch.bool" for a in node.args):
                return self.expr_taint(node)[0]
        return False

    def _fixpoint(self, fn_node: ast.AST) -> None:
        for _ in range(4):
            before = (len(self.value), len(self.shape), len(self.mask))
            for node in ast.walk(fn_node):
                targets: list[ast.expr] = []
                value: ast.expr | None = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AugAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets, value = [node.target], node.value
                elif isinstance(node, (ast.For, ast.comprehension)):
                    targets, value = [node.target], node.iter
                if value is None:
                    continue
                val, shp = self.expr_taint(value)
                mask = self.is_mask(value)
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            if val:
                                self.value.add(n.id)
                            elif shp:
                                self.shape.add(n.id)
                            if mask and isinstance(t, ast.Name):
                                self.mask.add(n.id)
            if (len(self.value), len(self.shape), len(self.mask)) == before:
                break


def _is_static_test(test: ast.expr) -> bool:
    """True for a branch condition that reads structure, not tensor
    values: `x is None` and other identity tests, membership
    (`"key" in d`: tree structure), comparisons with a string, and type
    and metadata predicates (isinstance, hasattr, callable, any `is_*`
    call such as is_dtensor or x.is_contiguous())."""
    if isinstance(test, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in test.ops):
            return True
        return any(isinstance(c, ast.Constant) and isinstance(c.value, str)
                   for c in [test.left, *test.comparators])
    if isinstance(test, ast.Call):
        d = dotted(test.func)
        tail = d.split(".")[-1] if d else _method(test)
        return tail in ("isinstance", "issubclass", "callable", "hasattr") \
            or tail.startswith("is_")
    return False


def _branch_parts(test: ast.expr) -> list[ast.expr]:
    """The atoms of a condition (`and`/`or`/`not` split apart)."""
    if isinstance(test, ast.BoolOp):
        return [p for v in test.values for p in _branch_parts(v)]
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _branch_parts(test.operand)
    return [test]


def _to_cpu(call: ast.Call) -> bool:
    """`.to("cpu")`, `.to(device="cpu")`, `.to(torch.device("cpu"))`."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    cands = list(call.args[:1]) + [k.value for k in call.keywords if k.arg == "device"]
    for c in cands:
        if isinstance(c, ast.Constant) and c.value == "cpu":
            return True
        if isinstance(c, ast.Call) and dotted(c.func) in ("torch.device", "device") \
                and c.args and isinstance(c.args[0], ast.Constant) and c.args[0].value == "cpu":
            return True
    return False


def _is_sync_call(call: ast.Call) -> bool:
    d = dotted(call.func)
    return d.endswith("cuda.synchronize") or (
        isinstance(call.func, ast.Attribute) and call.func.attr == "synchronize")


def _method(call: ast.Call) -> str:
    return call.func.attr if isinstance(call.func, ast.Attribute) else ""


def _numpy_alias(mod: ModuleInfo, d: str) -> bool:
    head = d.split(".")[0]
    return mod.aliases.get(head) == "numpy" or head in ("np", "numpy")


# -- device-block scope ------------------------------------------------


def _data_dependent(call: ast.Call, taint: Taint) -> str | None:
    """The name of a data-dependent-shape op this call is, or None."""
    d = dotted(call.func)
    tail = d.split(".")[-1] if d else _method(call)
    is_torch = d.startswith("torch.")
    is_method = isinstance(call.func, ast.Attribute) and not is_torch
    if tail in ("nonzero", "masked_select", "unique", "unique_consecutive",
                "argwhere") and (is_torch or is_method):
        return tail
    if tail == "where" and is_torch and len(call.args) == 1 and not call.keywords:
        return "one-argument torch.where"
    if tail == "repeat_interleave" and (is_torch or is_method):
        if any(k.arg == "output_size" for k in call.keywords):
            return None
        reps = call.args[1] if is_torch and len(call.args) > 1 else (
            call.args[0] if call.args else None)
        if reps is None:
            reps = next((k.value for k in call.keywords if k.arg == "repeats"), None)
        if is_torch and len(call.args) == 1:      # repeat_interleave(repeats)
            reps = call.args[0]
        if reps is not None and taint.expr_taint(reps)[0]:
            return "repeat_interleave without output_size"
    return None


def check_device(mod: ModuleInfo, fn: FuncInfo, nodes: list[ast.AST],
                 taint: Taint) -> list[Finding]:
    """The JT and RT003 rules over `nodes`, a device-block function's own
    nodes or a ``with no_host_sync`` body's."""
    findings: list[Finding] = []
    rel = mod.source.relpath

    def add(rule: str, node: ast.AST, msg: str, hint: str) -> None:
        findings.append(Finding(rule, rel, node.lineno, fn.qualname, msg, hint))

    def value(node: ast.expr) -> bool:
        return taint.expr_taint(node)[0]

    def shape_only(node: ast.expr) -> bool:
        v, s = taint.expr_taint(node)
        return s and not v

    # an error message is built on the way out, not on the device path
    raised = {id(n) for node in nodes if isinstance(node, ast.Raise)
              for n in ast.walk(node)}
    for node in nodes:
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            meth = _method(node)
            recv = node.func.value if isinstance(node.func, ast.Attribute) else None
            if meth == "item" and not node.args and not shape_only(recv):
                add("JT001", node, ".item() reads the device once per call",
                    "keep the value on the device; read it at the drain boundary")
            elif meth == "numpy" and not node.args:
                add("JT003", node, ".numpy() pulls a tensor to the host",
                    "move the conversion out of the device block, to the drain")
            elif meth in ("cpu", "tolist") and not shape_only(recv):
                add("JT004", node, f".{meth}() copies a tensor to the host",
                    "the device-to-host copy belongs at the drain boundary")
            elif _to_cpu(node):
                add("JT004", node, '.to("cpu") copies a tensor to the host',
                    "the device-to-host copy belongs at the drain boundary")
            elif _is_sync_call(node):
                add("JT005", node, "synchronize inside a device block",
                    "waiting belongs outside the block, at the measured drain point")
            if d in ("float", "int", "bool") and node.args and value(node.args[0]):
                add("JT002", node, f"{d}() of a tensor reads the device",
                    "use a tensor cast (x.to(dtype)) or keep it on the device")
            if d and _numpy_alias(mod, d) and d.split(".", 1)[-1] in ("asarray", "array") \
                    and node.args and value(node.args[0]):
                add("JT003", node, f"{d}() of a tensor pulls it to the host",
                    "move the conversion out of the device block, to the drain")
            if d in ("str", "repr", "format", "print") and node.args and any(
                    value(a) for a in node.args):
                add("RT003", node, f"{d}() of a tensor reads it to the host",
                    "log outside the device block, from drained values")
            op = _data_dependent(node, taint)
            if op is not None:
                add("JT007", node, f"{op}: the output shape depends on the data, "
                    "so the host waits for the device",
                    "use a fixed-shape form: torch.where(mask, a, b), a "
                    "scatter with a mask, or output_size=")
        elif isinstance(node, ast.Subscript):
            parts = node.slice.elts if isinstance(node.slice, ast.Tuple) else [node.slice]
            if any(taint.is_mask(p) for p in parts):
                add("JT007", node, "boolean-mask indexing: the output shape "
                    "depends on the data, so the host waits for the device",
                    "use torch.where(mask, a, b) or multiply by the mask")
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if any(value(p) for p in _branch_parts(node.test)
                   if not _is_static_test(p)):
                add("JT006", node.test, "Python branch on a tensor value reads the device",
                    "use torch.where / a masked update instead")
        elif isinstance(node, ast.JoinedStr) and id(node) not in raised:
            for val in node.values:
                if isinstance(val, ast.FormattedValue) and value(val.value):
                    add("RT003", node, "f-string interpolates a tensor (a device read)",
                        "log outside the device block, from drained values")
                    break
    return findings


def region_taint(fn: FuncInfo, nodes: list[ast.AST]) -> Taint:
    """A device region's taint: the function's tensor parameters plus
    every name bound inside the region (device results)."""
    bound = {n.id for node in nodes for n in ast.walk(node)
             if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
    return Taint(fn, extra=bound)


# -- hot host scope ----------------------------------------------------

_TORCH_HOST = {"equal", "is_tensor", "numel", "device", "Size", "finfo",
               "iinfo", "is_floating_point", "is_complex", "dtype",
               "get_default_dtype", "allclose", "is_grad_enabled"}
_BUILTINS_HOST = {"int", "float", "bool", "len", "sum", "min", "max", "abs",
                  "list", "tuple", "dict", "set", "zip", "range", "enumerate",
                  "sorted", "str", "repr", "any", "all", "round"}
_HOST_RESULT = {"numpy", "tolist", "item", "cpu"}
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}


class _Kinds:
    """Flow-sensitive guess of which names hold tensors ("tensor") and
    which hold host values ("host") in a hot host function, statement by
    statement in source order."""

    def __init__(self, proj: Project, mod: ModuleInfo, fn: FuncInfo):
        self.proj, self.mod, self.fn = proj, mod, fn
        self.kinds: dict[str, str] = {}

    def of(self, node: ast.expr | None) -> str | None:
        if node is None:
            return None
        if isinstance(node, ast.Name):
            return self.kinds.get(node.id)
        if isinstance(node, ast.Constant):
            return "host"
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return "host"
            return None if isinstance(node.value, ast.Name) and node.value.id == "self" \
                else self.of(node.value)
        if isinstance(node, ast.Subscript):
            return self.of(node.value)
        if isinstance(node, (ast.List, ast.Tuple)):
            ks = {self.of(e) for e in node.elts}
            return "tensor" if "tensor" in ks else ("host" if ks == {"host"} else None)
        if isinstance(node, (ast.BinOp, ast.Compare, ast.BoolOp, ast.UnaryOp)):
            parts = [n for n in ast.iter_child_nodes(node) if isinstance(n, ast.expr)]
            ks = {self.of(p) for p in parts}
            return "tensor" if "tensor" in ks else ("host" if ks == {"host"} else None)
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            meth = _method(node)
            if meth in _HOST_RESULT or _to_cpu(node):
                return "host"
            if d.startswith("torch."):
                return "host" if d.split(".")[1] in _TORCH_HOST or d.startswith(
                    "torch.cuda.") else "tensor"
            if d and _numpy_alias(self.mod, d):
                return "host"
            if d in _BUILTINS_HOST:
                return "host"
            tgt = self.proj.resolve_call(self.mod, self.fn, node)
            if tgt is not None and tgt in self.proj.device:
                return "tensor"
            if meth:
                return self.of(node.func.value)
        return None

    def bind(self, targets: list[ast.expr], kind: str | None) -> None:
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                    if kind is None:
                        self.kinds.pop(n.id, None)
                    else:
                        self.kinds[n.id] = kind

    def bind_comprehensions(self, stmt: ast.AST) -> None:
        for n in own_nodes(stmt):
            if isinstance(n, ast.comprehension):
                self.bind([n.target], self.of(n.iter))


def _hot_statements(body: list[ast.stmt], check: bool = True):
    """(part, binder, check) for the simple statements of a function body
    in source order (compound statements' headers, then their bodies).
    A ``with no_host_sync`` body is a device region, checked by the
    device-block rules: its statements only bind names here."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(stmt, (ast.If, ast.While)):
            yield stmt.test, None, check
            yield from _hot_statements(stmt.body, check)
            yield from _hot_statements(stmt.orelse, check)
        elif isinstance(stmt, ast.For):
            yield stmt.iter, stmt, check
            yield from _hot_statements(stmt.body, check)
            yield from _hot_statements(stmt.orelse, check)
        elif isinstance(stmt, ast.With):
            for it in stmt.items:
                yield it.context_expr, None, check
            yield from _hot_statements(stmt.body, check and not is_guard(stmt))
        elif isinstance(stmt, ast.Try):
            yield from _hot_statements(stmt.body, check)
            for h in stmt.handlers:
                yield from _hot_statements(h.body, check)
            yield from _hot_statements(stmt.orelse, check)
            yield from _hot_statements(stmt.finalbody, check)
        else:
            yield stmt, stmt, check


def check_hot(proj: Project, mod: ModuleInfo, fn: FuncInfo) -> list[Finding]:
    findings: list[Finding] = []
    rel = mod.source.relpath
    kinds = _Kinds(proj, mod, fn)

    def add(rule: str, node: ast.AST, msg: str, hint: str) -> None:
        findings.append(Finding(rule, rel, node.lineno, fn.qualname, msg, hint))

    for part, binder, checked in _hot_statements(fn.node.body):
        kinds.bind_comprehensions(part)
        for node in own_nodes(part) if checked else ():
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            meth = _method(node)
            recv = node.func.value if isinstance(node.func, ast.Attribute) else None
            if (meth in ("cpu", "numpy", "tolist") and not node.args
                    and kinds.of(recv) != "host") or _to_cpu(node):
                add("HS001", node, f"{'.to(cpu)' if meth == 'to' else '.' + meth + '()'} "
                    "in a host hot loop (a device read, counted against the sync budget)",
                    "batch reads at the single drain point, or suppress with justification")
            elif _is_sync_call(node):
                add("HS002", node, "synchronize in a host hot loop",
                    "only wait where the stall is the thing being measured")
            elif meth == "item" and not node.args and kinds.of(recv) != "host":
                add("HS003", node, ".item() in a host hot loop (one device read per call)",
                    "drain once per block, not once per value")
            elif d in ("int", "float", "bool") and node.args \
                    and kinds.of(node.args[0]) == "tensor":
                add("HS003", node, f"{d}() of a tensor in a host hot loop "
                    "(one device read per call)",
                    "drain once per block, not once per value")
        if isinstance(binder, ast.For):
            kinds.bind([binder.target], kinds.of(binder.iter))
        elif isinstance(binder, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = binder.targets if isinstance(binder, ast.Assign) else [binder.target]
            if binder.value is not None:
                kinds.bind(targets, kinds.of(binder.value))
    return findings


# -- PRNG discipline ---------------------------------------------------


def _walk_no_defs(node: ast.AST) -> list[ast.AST]:
    out: list[ast.AST] = []
    stack: list[ast.AST] = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) and n is not node:
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _is_const_seed(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_const_seed(e) for e in node.elts)
    return False


def check_prng(mod: ModuleInfo, fn: FuncInfo) -> list[Finding]:
    findings: list[Finding] = []
    rel = mod.source.relpath
    state: dict[str, str] = {}  # name -> "raw" | "folded"
    consumed: dict[str, int] = {}

    def add(rule: str, node: ast.AST, msg: str, hint: str) -> None:
        findings.append(Finding(rule, rel, node.lineno, fn.qualname, msg, hint))

    def classify_call(call: ast.Call) -> str | None:
        """'key' (a raw key), 'fold', 'split', 'consume' or None."""
        d = dotted(call.func)
        tail = d.split(".")[-1] if d else _method(call)
        keyed = "prng" in d or "random" in d or d == tail
        if tail in ("PRNGKey", "key") and keyed and not d.startswith(("torch.", "np.")):
            return "key"
        if tail == "fold_in":
            return "fold"
        if tail == "split" and ("prng" in d or "random" in d):
            return "split"
        if tail in KEY_CONSUMERS and ("prng" in d or d == tail):
            return "consume"
        return None

    def key_arg(call: ast.Call) -> str | None:
        if call.args and isinstance(call.args[0], ast.Name):
            return call.args[0].id
        return None

    def global_draw(call: ast.Call) -> str | None:
        d = dotted(call.func)
        if any(k.arg == "generator" for k in call.keywords):
            return None
        if d == "torch.manual_seed":
            return "torch.manual_seed reseeds torch's global generator"
        if d.startswith("torch.") and d.split(".")[-1] in GLOBAL_RNG_DRAWS \
                and d.count(".") == 1:
            return f"{d} draws from torch's global generator"
        if _method(call) in GLOBAL_RNG_METHODS and not d.startswith("torch."):
            return f".{_method(call)}() draws from torch's global generator"
        return None

    def process_calls(expr: ast.AST) -> None:
        for call in [n for n in _walk_no_defs(expr) if isinstance(n, ast.Call)]:
            kind = classify_call(call)
            d = dotted(call.func)
            if kind in ("consume", "split"):
                k = key_arg(call)
                if k is not None and k in state:
                    consumed[k] = consumed.get(k, 0) + 1
                    if kind == "consume" and state[k] == "raw":
                        add("PR001", call,
                            f"key '{k}' consumed without fold_in on a replay id",
                            "derive per-use keys with prng.fold_in(key, "
                            "round/tick/request id)")
                    if consumed[k] == 2:
                        add("PR002", call, f"key '{k}' consumed more than once",
                            "split or fold_in before each use; never reuse a key")
            elif "default_rng" in d:
                if call.args and _is_const_seed(call.args[0]):
                    add("PR001", call,
                        "np RNG seeded with a constant — not a function of a replay id",
                        "seed with a (seed, round/tick id) tuple so replay is bit-exact")
            elif _method(call) == "manual_seed" and d != "torch.manual_seed":
                if call.args and _is_const_seed(call.args[0]):
                    add("PR001", call,
                        "generator seeded with a constant — not a function of a replay id",
                        "seed from (seed, round/tick id) so replay is bit-exact")
            else:
                why = global_draw(call)
                if why is not None:
                    add("PR001", call, why + " (not keyed by a replay id)",
                        "draw from a torch.Generator seeded by (seed, replay id), "
                        "or from a fold_in key")

    def track_assign(stmt: ast.stmt) -> None:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            return
        new_state: str | None = None
        if isinstance(value, ast.Call):
            kind = classify_call(value)
            if kind == "key":
                new_state = "raw"
            elif kind == "fold":
                new_state = "folded"
            elif kind == "split":
                src = key_arg(value)
                new_state = state.get(src or "", "raw")
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    if new_state is not None:
                        state[n.id] = new_state
                        consumed[n.id] = 0
                    elif n.id in state:
                        del state[n.id]
                        consumed.pop(n.id, None)

    def visit_stmts(stmts: list[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # nested defs are linted as their own functions
            if isinstance(stmt, (ast.If, ast.While)):
                process_calls(stmt.test)
                visit_stmts(stmt.body)
                visit_stmts(stmt.orelse)
            elif isinstance(stmt, ast.For):
                process_calls(stmt.iter)
                track_assign(stmt)
                visit_stmts(stmt.body)
                visit_stmts(stmt.orelse)
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    process_calls(item.context_expr)
                visit_stmts(stmt.body)
            elif isinstance(stmt, ast.Try):
                visit_stmts(stmt.body)
                for h in stmt.handlers:
                    visit_stmts(h.body)
                visit_stmts(stmt.orelse)
                visit_stmts(stmt.finalbody)
            else:
                process_calls(stmt)
                track_assign(stmt)

    visit_stmts(fn.node.body)
    return findings


def replay_sensitive(mod: ModuleInfo) -> bool:
    return mod.name in REPLAY_SENSITIVE_MODULES or mod.lint_replay_sensitive


# -- DecodeState layout discipline ------------------------------------


def state_scoped(mod: ModuleInfo) -> bool:
    return mod.name in STATE_SCOPED_MODULES or mod.lint_state_scoped


def check_state_layout(mod: ModuleInfo, fn: FuncInfo) -> list[Finding]:
    """DS001: a state-scoped module (the serving plane) subscripted a
    family-private decode-state leaf like ``state["k"]`` or
    ``cache["rec_a"]``.  The plane handles decode state only through the
    DecodeState spec and the generic row ops (models/decode_state.py);
    the protocol-level per-row ``"pos"`` and the engine's own sampler
    keys are fine."""
    findings: list[Finding] = []
    rel = mod.source.relpath
    for node in own_nodes(fn.node):
        if not isinstance(node, ast.Subscript):
            continue
        sl = node.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str) \
                and sl.value in STATE_LAYOUT_KEYS:
            findings.append(
                Finding(
                    "DS001",
                    rel,
                    node.lineno,
                    fn.qualname,
                    f'family-layout key ["{sl.value}"] addressed in a '
                    f"state-scoped module",
                    "go through the DecodeState spec / generic row ops; "
                    "layout keys belong to models/decode_state.py",
                )
            )
    return findings
