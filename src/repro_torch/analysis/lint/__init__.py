"""The port's lint: static enforcement of the host-sync, PRNG and
state-layout invariants of the eager PyTorch hot paths, and budgets
measured by running the device entry points once.

Layer 1 (this module + ``rules.py``/``callgraph.py``) is pure stdlib-AST
and runs in milliseconds; it imports no torch.  Layer 2 (``budgets.py``)
runs each entry's device function eagerly on a reduced config under a
host-sync count, a collective count and the engine's compiled-variant
count; it imports torch and is invoked with ``--budgets``.

Usage::

    python -m repro_torch.analysis.lint                 # AST layer over src/repro_torch
    python -m repro_torch.analysis.lint --budgets       # + the budget layer
    python -m repro_torch.analysis.lint --paths f.py    # lint specific files
"""

from __future__ import annotations

from pathlib import Path

from .callgraph import Project, own_nodes, region_nodes
from .findings import Finding, SourceFile, apply_suppressions, load_baseline
from .rules import (
    NO_COUNTERPART,
    RULE_CATALOG,
    check_device,
    check_hot,
    check_prng,
    check_state_layout,
    region_taint,
    replay_sensitive,
    state_scoped,
    Taint,
)

REPO_ROOT = Path(__file__).resolve().parents[4]
SRC_ROOT = REPO_ROOT / "src"
DEFAULT_SCAN = SRC_ROOT / "repro_torch"
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.txt"

__all__ = [
    "Finding",
    "NO_COUNTERPART",
    "RULE_CATALOG",
    "lint_paths",
    "BASELINE_PATH",
    "REPO_ROOT",
]


def _module_name(path: Path) -> tuple[str, bool]:
    """(dotted module name, is a package) for a file (fixtures fall back
    to their stem)."""
    try:
        rel = path.resolve().relative_to(SRC_ROOT)
    except ValueError:
        return path.stem, False
    parts = rel.with_suffix("").parts
    if parts[-1] == "__init__":
        return ".".join(parts[:-1]), True
    return ".".join(parts), False


def _relpath(path: Path) -> str:
    try:
        return path.resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return path.as_posix()


def collect_files(paths: list[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def lint_paths(
    paths: list[Path] | None = None,
    use_baseline: bool = True,
) -> tuple[list[Finding], int]:
    """Run the AST layer.  Returns (findings, suppressed_count)."""
    files = collect_files(paths or [DEFAULT_SCAN])
    sources: dict[str, SourceFile] = {}
    modules: list[tuple[str, SourceFile, bool]] = []
    for f in files:
        src = SourceFile(path=f.resolve(), relpath=_relpath(f), text=f.read_text())
        sources[src.relpath] = src
        name, is_pkg = _module_name(f)
        modules.append((name, src, is_pkg))

    proj = Project.load(modules)
    raw: list[Finding] = []

    for mod_name, mod in proj.modules.items():
        for qual, fn in mod.functions.items():
            key = (mod_name, qual)
            if key in proj.device:
                raw.extend(check_device(mod, fn, own_nodes(fn.node), Taint(fn)))
            elif key in proj.hot:
                raw.extend(check_hot(proj, mod, fn))
            if replay_sensitive(mod):
                raw.extend(check_prng(mod, fn))
            if state_scoped(mod):
                raw.extend(check_state_layout(mod, fn))
        for region in mod.regions:
            if (mod_name, region.fn.qualname) in proj.device:
                continue          # the whole function is checked already
            nodes = region_nodes(region)
            raw.extend(check_device(mod, region.fn, nodes,
                                    region_taint(region.fn, nodes)))

    # one finding per (rule, site): a region nested in another is walked twice
    raw = list({(f.rule, f.path, f.line, f.qualname): f for f in raw}.values())
    baseline = load_baseline(BASELINE_PATH) if use_baseline else {}
    final, suppressed = apply_suppressions(raw, sources, baseline, use_baseline=use_baseline)
    final.sort(key=lambda f: (f.path, f.line, f.rule))
    return final, suppressed
