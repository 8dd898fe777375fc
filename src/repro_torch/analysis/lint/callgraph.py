"""Module indexing, device-block detection, call-graph reachability.

Pure-stdlib ``ast`` analysis; nothing here imports torch, so the AST
layer runs in milliseconds as a pre-gate.

Scopes computed per project:

* **device-block scope** — code that runs as one device block with no
  host sync (the counterpart of the reference's jit-traced scope): the
  registry's ``DEVICE_BLOCK_ENTRY_POINTS`` and every call made inside a
  ``with no_host_sync(...)`` body, plus everything reachable from those
  through resolvable calls.  The ``with`` bodies themselves are device
  regions: checked by the same rules.
* **hot scope** — host-side hot loops from the registry
  (``ServingEngine.step/run`` etc.) plus everything reachable, minus the
  device-block scope.  Host syncs here are budgeted, not forbidden —
  hence the suppression machinery.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .findings import SourceFile
from .registry import DEVICE_BLOCK_ENTRY_POINTS, HOT_ENTRY_POINTS

# the context manager that marks a device block
GUARD = "no_host_sync"


@dataclass
class FuncInfo:
    qualname: str
    node: ast.FunctionDef | ast.AsyncFunctionDef
    module: "ModuleInfo"

    @property
    def cls(self) -> str | None:
        parts = self.qualname.split(".")
        return parts[-2] if len(parts) >= 2 else None


@dataclass
class Region:
    """A ``with no_host_sync(...)`` body inside function `fn`."""

    fn: FuncInfo
    node: ast.With


def dotted(node: ast.expr) -> str:
    """Render a Name/Attribute chain as 'a.b.c' ('' if not a plain chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _str_list(node: ast.expr) -> tuple[str, ...]:
    if isinstance(node, (ast.List, ast.Tuple)):
        return tuple(e.value for e in node.elts
                     if isinstance(e, ast.Constant) and isinstance(e.value, str))
    return ()


def is_guard(with_node: ast.With) -> bool:
    return any(isinstance(it.context_expr, ast.Call)
               and dotted(it.context_expr.func).split(".")[-1] == GUARD
               for it in with_node.items)


class ModuleInfo:
    def __init__(self, name: str, source: SourceFile, is_package: bool = False):
        self.name = name
        self.source = source
        self.package = name if is_package else name.rpartition(".")[0]
        self.tree = ast.parse(source.text, filename=str(source.path))
        self.functions: dict[str, FuncInfo] = {}
        self.aliases: dict[str, str] = {}  # local name -> dotted module
        self.from_imports: dict[str, tuple[str, str]] = {}  # local -> (module, attr)
        self.regions: list[Region] = []
        self.lint_hot_entry_points: tuple[str, ...] = ()
        self.lint_device_block_entry_points: tuple[str, ...] = ()
        self.lint_replay_sensitive = False
        self.lint_state_scoped = False
        self._index()

    # -- indexing -----------------------------------------------------
    def _index(self) -> None:
        self._walk_scope(self.tree.body, prefix="")
        for node in self.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if name == "LINT_HOT_ENTRY_POINTS":
                self.lint_hot_entry_points = _str_list(node.value)
            elif name == "LINT_DEVICE_BLOCK_ENTRY_POINTS":
                self.lint_device_block_entry_points = _str_list(node.value)
            elif name == "LINT_REPLAY_SENSITIVE" and isinstance(node.value, ast.Constant):
                self.lint_replay_sensitive = bool(node.value.value)
            elif name == "LINT_STATE_SCOPED" and isinstance(node.value, ast.Constant):
                self.lint_state_scoped = bool(node.value.value)
        for fn in self.functions.values():
            for node in own_nodes(fn.node):
                if isinstance(node, ast.With) and is_guard(node):
                    self.regions.append(Region(fn, node))

    def _absolute(self, module: str | None, level: int) -> str:
        """The dotted module an ``import`` names (relative ones resolved
        against this module's package)."""
        if not level:
            return module or ""
        base = self.package.split(".") if self.package else []
        base = base[:len(base) - (level - 1)] if level > 1 else base
        return ".".join(base + ([module] if module else []))

    def _walk_scope(self, body: list[ast.stmt], prefix: str) -> None:
        for node in body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom):
                mod = self._absolute(node.module, node.level)
                for a in node.names:
                    self.from_imports[a.asname or a.name] = (mod, a.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                self.functions[qual] = FuncInfo(qual, node, self)
                self._walk_scope(node.body, prefix=f"{qual}.")
            elif isinstance(node, ast.ClassDef):
                self._walk_scope(node.body, prefix=f"{prefix}{node.name}.")
            elif isinstance(node, (ast.If, ast.Try, ast.With, ast.For, ast.While)):
                # functions defined under guards, and function-local imports
                inner: list[ast.stmt] = list(getattr(node, "body", []))
                inner += list(getattr(node, "orelse", []))
                inner += list(getattr(node, "finalbody", []))
                for h in getattr(node, "handlers", []):
                    inner += h.body
                self._walk_scope(inner, prefix=prefix)


def own_nodes(fn_node: ast.AST) -> list[ast.AST]:
    """All nodes of a function (or a statement) excluding nested function
    bodies, which are indexed and linted as functions of their own
    (a lambda's body is not: it counts as its enclosing function's)."""
    out: list[ast.AST] = []
    stack: list[ast.AST] = [fn_node]
    first = True
    while stack:
        node = stack.pop()
        if not first and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        first = False
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def region_nodes(region: Region) -> list[ast.AST]:
    """The nodes of a device region's body (nested defs excluded)."""
    return [n for stmt in region.node.body for n in own_nodes(stmt)]


@dataclass
class Project:
    modules: dict[str, ModuleInfo] = field(default_factory=dict)
    device: set[tuple[str, str]] = field(default_factory=set)  # (module, qualname)
    hot: set[tuple[str, str]] = field(default_factory=set)

    @classmethod
    def load(cls, files: list[tuple[str, SourceFile, bool]]) -> "Project":
        proj = cls()
        for name, src, is_pkg in files:
            proj.modules[name] = ModuleInfo(name, src, is_pkg)
        proj._compute_scopes()
        return proj

    # -- call resolution ----------------------------------------------
    def resolve_call(
        self, mod: ModuleInfo, caller: FuncInfo | None, call: ast.Call
    ) -> tuple[str, str] | None:
        d = dotted(call.func)
        if not d:
            return None
        if d.startswith("self.") and caller is not None and caller.cls:
            meth = d.split(".", 1)[1]
            qual = f"{caller.cls}.{meth}"
            if qual in mod.functions:
                return (mod.name, qual)
            # a method defined on the class enclosing a nested function
            for q in mod.functions:
                if q.endswith(f".{meth}") and caller.qualname.startswith(
                        q.rsplit(".", 1)[0] + "."):
                    return (mod.name, q)
            return None
        if "." not in d:
            # nested sibling first, then module-level, then from-import
            if caller is not None:
                scope = caller.qualname.rsplit(".", 1)[0] if "." in caller.qualname else ""
                while scope:
                    qual = f"{scope}.{d}"
                    if qual in mod.functions:
                        return (mod.name, qual)
                    scope = scope.rsplit(".", 1)[0] if "." in scope else ""
                qual = f"{caller.qualname}.{d}"
                if qual in mod.functions:
                    return (mod.name, qual)
            if d in mod.functions:
                return (mod.name, d)
            if d in mod.from_imports:
                src_mod, attr = mod.from_imports[d]
                target = self._lookup_module(src_mod)
                if target and attr in target.functions:
                    return (target.name, attr)
            return None
        head, rest = d.split(".", 1)
        if head in mod.aliases:
            target = self._lookup_module(mod.aliases[head])
            if target and rest in target.functions:
                return (target.name, rest)
        if head in mod.from_imports:
            src_mod, attr = mod.from_imports[head]
            target = self._lookup_module(f"{src_mod}.{attr}" if src_mod else attr)
            if target and rest in target.functions:
                return (target.name, rest)
        return None

    def _lookup_module(self, dotted_name: str) -> ModuleInfo | None:
        if dotted_name in self.modules:
            return self.modules[dotted_name]
        for name, m in self.modules.items():
            if name.endswith("." + dotted_name) or name.split(".")[-1] == dotted_name:
                return m
        return None

    # -- scopes -------------------------------------------------------
    def _reachable(self, seeds: set[tuple[str, str]]) -> set[tuple[str, str]]:
        seen = set(seeds)
        frontier = list(seeds)
        while frontier:
            mod_name, qual = frontier.pop()
            mod = self.modules.get(mod_name)
            if mod is None or qual not in mod.functions:
                continue
            fn = mod.functions[qual]
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call):
                    tgt = self.resolve_call(mod, fn, node)
                    if tgt and tgt not in seen:
                        seen.add(tgt)
                        frontier.append(tgt)
        return seen

    def _compute_scopes(self) -> None:
        device_seeds: set[tuple[str, str]] = set()
        hot_seeds: set[tuple[str, str]] = set()
        for name, mod in self.modules.items():
            declared = (DEVICE_BLOCK_ENTRY_POINTS.get(name, ())
                        + mod.lint_device_block_entry_points)
            device_seeds |= {(name, q) for q in declared if q in mod.functions}
            for region in mod.regions:
                for node in region_nodes(region):
                    if isinstance(node, ast.Call):
                        tgt = self.resolve_call(mod, region.fn, node)
                        if tgt is not None:
                            device_seeds.add(tgt)
            declared = HOT_ENTRY_POINTS.get(name, ()) + mod.lint_hot_entry_points
            hot_seeds |= {(name, q) for q in declared if q in mod.functions}
        self.device = self._reachable(device_seeds)
        self.hot = self._reachable(hot_seeds) - self.device
