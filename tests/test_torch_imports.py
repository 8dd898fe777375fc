"""The PyTorch port stands alone: no module of `src/repro_torch/`, no
port example (`examples/torch_port/`) and not `chip_smoke.py` imports jax
or the JAX package, every module imports with both blocked (the paper
runner's `__main__` doing nothing on import), and the port's serve
launcher runs on the CPU only when asked to (the train launcher's CLI:
tests/test_torch_training.py)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
FILES = sorted((SRC / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples" / "torch_port").glob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    assert len(FILES) > 10 and all(p.exists() for p in FILES)
    assert len([p for p in FILES if p.parent.name == "torch_port"]) == 5


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_every_port_module_imports_without_jax_or_the_reference():
    mods = sorted(".".join(p.relative_to(SRC).with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in FILES if p.is_relative_to(SRC))
    assert "repro_torch.train.fault_tolerance" in mods
    assert "repro_torch.paper.__main__" in mods
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=240,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    # the runner's work sits under its __main__ guard: importing it
    # prints nothing (unguarded, it would print its CSV header or refuse
    # the default device)
    assert proc.stdout == "", proc.stdout[-2000:]


def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)


def test_serve_cli_runs_on_cpu_when_asked():
    proc = _serve("--device", "cpu", "--requests", "2", "--slots", "2",
                  "--max-len", "64", "--max-new-tokens", "4")
    assert proc.returncode == 0, proc.stderr
    assert "served 2 requests" in proc.stdout
    assert "kernel launches: dense 0, paged 0" in proc.stdout


def test_serve_cli_default_device_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    proc = _serve("--requests", "2", "--slots", "2", "--max-len", "64",
                  "--max-new-tokens", "4")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "Traceback" not in proc.stderr
