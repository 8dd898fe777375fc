"""Build and load a CUDA kernel library with a plain C interface.

`nvcc` compiles one `.cu` source for `sm_90a` into a shared library under
the gitignored `build/` directory beside it, at first use and once per
source content (the file name carries a hash of the source and the flags);
`ctypes` loads it.  Nothing here runs at import, so the CPU tests import
the kernel modules freely.  A build that fails raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


class Library:
    """One kernel library: `load()` builds it if needed and returns the
    CDLL, after `declare(lib)` has set the functions' argtypes.  `log` is
    what `nvcc` printed (registers, spills) and `seconds` the time of the
    first `load()`."""

    def __init__(self, source: Path, declare):
        self.source = source
        self.declare = declare
        self.lib = None
        self.log = ""
        self.seconds = 0.0

    def load(self) -> ctypes.CDLL:
        if self.lib is not None:
            return self.lib
        t0 = time.perf_counter()
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        build_dir = self.source.parent.parent / "build"
        so = build_dir / f"{self.source.stem}_{digest}.so"
        if not so.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(self.source)], capture_output=True,
                                  text=True)
            self.log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{self.source.name}:\n{self.log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        self.declare(lib)
        self.lib = lib
        self.seconds = time.perf_counter() - t0
        return lib


def raise_on(err: int, name: str):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
