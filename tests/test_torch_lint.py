"""The port's lint (`python -m repro_torch.analysis.lint`).

  1. Every bad fixture in tests/torch_lint_fixtures/ fires exactly the
     rule its `# LINT-EXPECT: <RULE>` marker names, at that line, in
     process and through the CLI (which exits 1).
  2. The clean fixture (near misses the port relies on) and the port's
     own tree lint clean, the tree with its intentional drains
     suppressed and mirrored in baseline.txt.
  3. Every rule of the reference's catalog is a port rule or has a
     stated reason in NO_COUNTERPART.
  4. The budget layer: every entry passes on the CPU with 0 host syncs,
     0 decode collective bytes and len(buckets) + 1 compiled variants,
     and the hidden regression entry (the simulated int8 hop, which
     gathers the f32 deltas whole) fails BG002; a host read planted in
     the engine's decode block is caught by the host-sync count.
The AST layer imports no torch: its CLI runs are cheap subprocesses."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.lint.rules import RULE_CATALOG as REF_CATALOG  # noqa: E402
from repro_torch.analysis.collectives import HostSyncCounter  # noqa: E402
from repro_torch.analysis.lint import (BASELINE_PATH, NO_COUNTERPART,  # noqa: E402
                                       RULE_CATALOG, lint_paths)
from repro_torch.analysis.lint.budgets import BUDGETS, PLANTS  # noqa: E402
from repro_torch.analysis.lint.findings import (ALLOW_RE,  # noqa: E402
                                                BASELINE_RE, load_baseline)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_lint_fixtures"
MARKER_RE = re.compile(r"#\s*LINT-EXPECT:\s*([A-Z]{2}\d{3})")
BAD_FIXTURES = sorted(p for p in FIXTURES.glob("*.py") if p.stem != "clean")
VISIBLE = [n for n, s in BUDGETS.items() if not s.hidden]
REGRESSION = "diloco-outer-sync-regression"


def _expected(path: Path) -> tuple[str, int]:
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        m = MARKER_RE.search(line)
        if m:
            return m.group(1), i
    raise AssertionError(f"{path} has no LINT-EXPECT marker")


def _run_cli(*args: str, timeout=120) -> subprocess.CompletedProcess:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)


# -- fixtures ------------------------------------------------------------------
@pytest.fixture(scope="module")
def cli_bad():
    """One CLI run over every bad fixture: {fixture name: [(rule, line)]}."""
    proc = _run_cli("--paths", *map(str, BAD_FIXTURES), "--json")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    got = {}
    for f in json.loads(proc.stdout):
        got.setdefault(Path(f["path"]).name, []).append((f["rule"], f["line"]))
    return got


@pytest.mark.parametrize("fixture", BAD_FIXTURES, ids=lambda p: p.stem)
def test_bad_fixture_fires_exactly_its_rule(fixture):
    rule, line = _expected(fixture)
    findings, _ = lint_paths([fixture])
    assert [(f.rule, f.line) for f in findings] == [(rule, line)], \
        [f.render() for f in findings]
    assert findings[0].path == f"tests/torch_lint_fixtures/{fixture.name}"


@pytest.mark.parametrize("fixture", BAD_FIXTURES, ids=lambda p: p.stem)
def test_cli_reports_exactly_the_rule_of_each_bad_fixture(cli_bad, fixture):
    assert cli_bad[fixture.name] == [_expected(fixture)]


def test_cli_exits_zero_on_the_clean_fixture():
    proc = _run_cli("--paths", str(FIXTURES / "clean.py"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert lint_paths([FIXTURES / "clean.py"])[0] == []


def test_every_rule_has_a_fixture_or_budget_coverage():
    covered = {_expected(p)[0] for p in BAD_FIXTURES}
    assert covered | {"BG001", "BG002", "BG003"} == set(RULE_CATALOG)


# more shapes of the device-block rules than one fixture each holds
DEVICE_SNIPPETS = {
    "x.nonzero()": "JT007", "torch.unique(x)": "JT007",
    "torch.masked_select(x, x > 0)": "JT007",
    "torch.repeat_interleave(x, n)": "JT007", "torch.where(x > 0)": "JT007",
    "x.tolist()": "JT004", 'x.to("cpu")': "JT004", "x.numpy()": "JT003",
    "bool(x.any())": "JT002", "int(x.sum())": "JT002",
    "str(x)": "RT003", "print(x)": "RT003",
    "x.repeat_interleave(2)": None, "int(x.shape[0])": None,
    "torch.repeat_interleave(x, n, output_size=8)": None,
    "torch.where(x > 0, x, 0)": None, "x.to(torch.int32)": None,
}


@pytest.mark.parametrize("expr", DEVICE_SNIPPETS)
def test_device_block_rule_shapes(tmp_path, expr):
    src = tmp_path / "snippet.py"
    src.write_text("import torch\n\nLINT_DEVICE_BLOCK_ENTRY_POINTS = "
                   f"['step']\n\n\ndef step(x, n):\n    return {expr}\n")
    rules = [f.rule for f in lint_paths([src])[0]]
    want = DEVICE_SNIPPETS[expr]
    assert rules == ([want] if want else []), rules


# -- the port's tree -------------------------------------------------------------
def test_the_port_lints_clean_with_its_drains_suppressed():
    findings, suppressed = lint_paths(None)
    assert findings == [], [f.render() for f in findings]
    assert suppressed > 0
    proc = _run_cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK repro-lint: 0 finding(s)")


def test_baseline_entries_are_well_formed():
    lines = [ln.strip() for ln in BASELINE_PATH.read_text().splitlines()]
    entries = [ln for ln in lines if ln and not ln.startswith("#")]
    assert entries
    for line in entries:
        m = BASELINE_RE.match(line)
        assert m, f"malformed baseline line: {line!r}"
        assert m.group("why"), f"baseline entry without reason: {line!r}"
        assert m.group("rule") in RULE_CATALOG
        assert m.group("key").startswith("src/repro_torch/")
    assert len(load_baseline(BASELINE_PATH)) == len(entries)


def test_every_reference_rule_is_mapped_or_has_a_reason():
    missing = set(REF_CATALOG) - set(RULE_CATALOG) - set(NO_COUNTERPART)
    assert not missing, missing
    assert not set(NO_COUNTERPART) & set(RULE_CATALOG)
    assert all(len(why) > 40 for why in NO_COUNTERPART.values())


def test_suppression_parsing():
    m = ALLOW_RE.search("x = 1  # repro-lint: allow[JT004]  # other marker")
    assert m and m.group("rule") == "JT004" and not m.group("why").strip()
    m = ALLOW_RE.search("x = 1  # repro-lint: allow[HS001] the one drain")
    assert m and m.group("why").strip() == "the one drain"


def test_the_ast_layer_imports_no_torch():
    code = ("import sys\nimport repro_torch.analysis.lint.__main__\n"
            "print('torch' in sys.modules, 'numpy' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=60,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.stdout.split() == ["False", "False"], proc.stderr


def test_the_analysis_package_exports_the_same_names_lazily():
    import importlib

    import repro_torch.analysis as pkg
    module = importlib.import_module("repro_torch.analysis.roofline")
    assert pkg.roofline is module.roofline        # the function, not the module
    for name in pkg.__all__:
        assert getattr(pkg, name) is not None


# -- host-sync counter -------------------------------------------------------------
READS = {
    "item": lambda x: x[0].item(), "cpu": lambda x: x.cpu(),
    "tolist": lambda x: x.tolist(), "numpy": lambda x: x.numpy(),
    "asarray": lambda x: __import__("numpy").asarray(x),
    "to_cpu": lambda x: x.to("cpu"), "bool": lambda x: bool(x[0]),
    "float": lambda x: float(x[1]), "if": lambda x: 1 if x[1] else 0,
    "fstring": lambda x: f"{x}", "nonzero": lambda x: torch.nonzero(x),
    "mask": lambda x: x[x > 1], "unique": lambda x: torch.unique(x),
    "masked_select": lambda x: torch.masked_select(x, x > 1),
    "repeat_interleave": lambda x: torch.repeat_interleave(
        x, torch.tensor([1, 2, 1, 0])),
}
NO_READS = {
    "arith": lambda x: (x * 2).sum(0), "where": lambda x: torch.where(
        x > 1, x, 0), "cast": lambda x: x.to(torch.int32),
    "same_device": lambda x: x.to(x.device),
    "repeat_int": lambda x: x.repeat_interleave(2),
    "repeat_sized": lambda x: torch.repeat_interleave(
        x, torch.tensor([1, 2, 1, 0]), output_size=4),
    "shape": lambda x: int(x.shape[0]),
}


@pytest.mark.parametrize("kind", list(READS) + list(NO_READS))
def test_host_sync_counter_counts_each_read_once(kind):
    x = torch.arange(4.0)
    counter = HostSyncCounter()
    with counter:
        (READS.get(kind) or NO_READS[kind])(x)
    assert counter.host_syncs()["count"] == (1 if kind in READS else 0), \
        counter.host_syncs()


# -- budgets ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def budget_run():
    """One CLI run of every entry, the hidden regression one included:
    (exit code, stdout)."""
    proc = _run_cli("--budgets", "--only", *VISIBLE, REGRESSION, timeout=600)
    return proc.returncode, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", VISIBLE)
def test_budget_entry_passes_on_the_cpu(budget_run, name):
    rc, out = budget_run
    line = re.search(rf"^budget {re.escape(name)}: (.*)$", out, re.M)
    assert line, out[-3000:]
    fields = dict(kv.split("=", 1) for kv in line.group(1).split(", "))
    assert fields["ok"] == "True" and fields["host_syncs"] == "0", line.group(0)
    if name.startswith("engine-serve"):
        assert fields["decode_wire_bytes"] == "0"
        assert fields["traces"] == "4"                 # len(buckets) + 1
    if name.startswith("diloco-outer-sync"):
        assert float(fields["ratio"]) <= 2.0
    assert f"[{name}]" not in out                     # no finding of its own


def test_regression_entry_fails_the_wire_budget(budget_run):
    rc, out = budget_run
    assert rc == 1
    findings = re.findall(r"^(BG\d{3}) \S+ \[([\w-]+)\]", out, re.M)
    assert findings == [("BG002", REGRESSION)], out[-3000:]
    assert "all-gather" in out


@pytest.mark.parametrize("kind", PLANTS)
def test_planted_host_read_in_a_decode_block_is_counted(kind):
    from repro_torch.analysis.lint.budgets import run_budget_checks
    findings, reports = run_budget_checks(only=["engine-serve"], plant=kind)
    decode = [f for f in findings
              if f.rule == "BG001" and "decode block" in f.message]
    assert decode, [f.render() for f in findings]
    assert reports["engine-serve"]["host_syncs"] >= 1
