"""CLI for the port's lint.

Exit status: 0 clean, 1 findings, 2 internal error.

The AST layer imports no torch.  The budget layer (``--budgets``) imports
torch, runs each entry's device function once on a reduced config on
``--device`` and prints one line per entry (host syncs by each count,
pod-axis wire bytes, compiled variants) before the findings.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import DEFAULT_SCAN, lint_paths
from .findings import Finding
from .rules import NO_COUNTERPART, RULE_CATALOG


def _as_dict(f: Finding) -> dict:
    return {"rule": f.rule, "path": f.path, "line": f.line,
            "qualname": f.qualname, "message": f.message, "hint": f.hint}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's static analysis: host-sync, PRNG and "
                    "state-layout invariants, and measured budgets",
    )
    ap.add_argument("--paths", nargs="*", type=Path, default=None,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--budgets", action="store_true",
                    help="also run the budget layer (imports torch; runs "
                         "each entry's device function once)")
    ap.add_argument("--only", nargs="+", default=None, metavar="NAME",
                    help="budget layer: run only these BUDGETS entries "
                         "(hidden ones included) and skip the AST layer")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"],
                    help="budget layer: where the entries run (cuda adds "
                         "sync debug mode as a second host-sync count)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore baseline.txt (inline allows still need justifications)")
    ap.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    ap.add_argument("--json", action="store_true", help="emit findings as JSON")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULE_CATALOG.items()):
            print(f"{rule}  {desc}")
        for rule, why in sorted(NO_COUNTERPART.items()):
            print(f"{rule}  (no counterpart) {why}")
        return 0

    findings: list[Finding] = []
    suppressed = 0
    if not (args.budgets and args.only):
        ast_findings, suppressed = lint_paths(args.paths, use_baseline=not args.no_baseline)
        findings.extend(ast_findings)
    if args.budgets:
        from .budgets import run_budget_checks

        budget_findings, reports = run_budget_checks(only=args.only, device=args.device)
        findings.extend(budget_findings)
        if not args.json:
            for name, rep in reports.items():
                print(f"budget {name}: " + ", ".join(f"{k}={v}" for k, v in rep.items()))

    if args.json:
        print(json.dumps([_as_dict(f) for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        if args.budgets and args.only:
            scope = "budget entries " + ", ".join(args.only)
        else:
            scope = ", ".join(str(p) for p in (args.paths or [DEFAULT_SCAN]))
            if args.budgets:
                scope += f" + budgets ({args.device})"
        tail = f"repro-lint: {len(findings)} finding(s), {suppressed} suppressed ({scope})"
        print(("FAIL " if findings else "OK ") + tail)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
