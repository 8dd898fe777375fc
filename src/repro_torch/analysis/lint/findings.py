"""Finding type, inline-suppression parsing, and the checked-in baseline.

Suppression contract (enforced, not advisory):

* a finding line may carry ``# repro-lint: allow[RULE] <justification>``;
  the justification text is mandatory (empty → LN001);
* every inline allow must be mirrored by a line in
  ``src/repro_torch/analysis/lint/baseline.txt`` of the form
  ``RULE <relpath>::<qualname> -- <reason>`` (missing → LN002);
* a baseline line that matches no live suppressed finding is stale and
  also reported as LN002, so the baseline can only shrink or be edited
  deliberately.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

# the justification stops at a following '#' so trailing markers/comments
# don't masquerade as a reason
ALLOW_RE = re.compile(r"#\s*repro-lint:\s*allow\[(?P<rule>[A-Z]{2}\d{3})\]\s*(?P<why>[^#]*)")
BASELINE_RE = re.compile(
    r"^(?P<rule>[A-Z]{2}\d{3})\s+(?P<key>\S+)\s*(?:--\s*(?P<why>.+))?$"
)


@dataclass
class Finding:
    rule: str
    path: str  # repo-relative
    line: int
    qualname: str  # enclosing function/method qualname ("<module>" at top level)
    message: str
    hint: str = ""
    suppressed: bool = False

    @property
    def key(self) -> str:
        return f"{self.path}::{self.qualname}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        out = f"{self.rule} {loc} [{self.qualname}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclass
class SourceFile:
    path: Path  # absolute
    relpath: str  # repo-relative, forward slashes
    text: str
    lines: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.lines:
            self.lines = self.text.splitlines()

    def allow_at(self, line: int) -> tuple[str, str] | None:
        """Return (rule, justification) if line carries an allow comment."""
        if 1 <= line <= len(self.lines):
            m = ALLOW_RE.search(self.lines[line - 1])
            if m:
                return m.group("rule"), m.group("why").strip()
        return None


def load_baseline(path: Path) -> dict[tuple[str, str], str]:
    """Parse baseline.txt -> {(rule, 'relpath::qualname'): reason}."""
    entries: dict[tuple[str, str], str] = {}
    if not path.exists():
        return entries
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = BASELINE_RE.match(line)
        if m:
            entries[(m.group("rule"), m.group("key"))] = m.group("why") or ""
    return entries


def apply_suppressions(
    findings: list[Finding],
    sources: dict[str, SourceFile],
    baseline: dict[tuple[str, str], str],
    use_baseline: bool = True,
) -> tuple[list[Finding], int]:
    """Apply inline allows + baseline; emit LN001/LN002 meta-findings.

    Returns ``(final_findings, suppressed_count)`` — suppressed findings
    are dropped from the list.
    """
    out: list[Finding] = []
    n_suppressed = 0
    used_baseline: set[tuple[str, str]] = set()
    for f in findings:
        src = sources.get(f.path)
        allow = src.allow_at(f.line) if src else None
        if allow is None:
            out.append(f)
            continue
        rule, why = allow
        if rule != f.rule:
            out.append(f)  # allow for a different rule does not apply
            continue
        if not why:
            out.append(
                Finding(
                    "LN001",
                    f.path,
                    f.line,
                    f.qualname,
                    f"suppression of {f.rule} has no justification",
                    hint="write `# repro-lint: allow[%s] <why this is intentional>`" % f.rule,
                )
            )
            continue
        if use_baseline and (f.rule, f.key) not in baseline:
            out.append(
                Finding(
                    "LN002",
                    f.path,
                    f.line,
                    f.qualname,
                    f"inline allow[{f.rule}] not mirrored in baseline.txt",
                    hint=f"add `{f.rule} {f.key} -- {why}` to src/repro_torch/analysis/lint/baseline.txt",
                )
            )
            continue
        used_baseline.add((f.rule, f.key))
        f.suppressed = True
        n_suppressed += 1
    if use_baseline:
        for (rule, key), why in baseline.items():
            # Staleness is only decidable for files in this scan's scope.
            if key.split("::", 1)[0] not in sources:
                continue
            if (rule, key) not in used_baseline:
                out.append(
                    Finding(
                        "LN002",
                        key.split("::", 1)[0],
                        0,
                        key.split("::", 1)[-1],
                        f"stale baseline entry {rule} {key} matches no suppressed finding",
                        hint="delete the line from baseline.txt",
                    )
                )
    return out, n_suppressed
