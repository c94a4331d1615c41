"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``csrc/`` becomes a shared library with a plain C
interface, built at first use into ``_build/`` next to this package (listed
in .gitignore) and named by a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused.  There is no fallback:
without nvcc or a card, building or loading raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCES = {name: PACKAGE_DIR / "csrc" / f"{name}.cu"
           for name in ("megakernel", "sweeps")}
BUILD_DIR = PACKAGE_DIR / "_build"
# --fmad=false: no contraction of a * b + c into one rounding, so the kernels
# round like their plain PyTorch versions (see csrc/megakernel.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildReport:
    name: str
    library: Path
    seconds: float      # 0.0 when an earlier build was reused
    ptxas: str          # nvcc's -Xptxas -v report (registers, spills)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); the "
                       "port's CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, BuildReport]:
    """Compile the named sources, one nvcc process each, all started
    together.  Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports: Dict[str, BuildReport] = {}
    running = {}
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            reports[name] = BuildReport(name, lib, 0.0, "(reused)")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{out}")
        os.replace(tmp, lib)
        reports[name] = BuildReport(name, lib, time.perf_counter() - t0, out)
    return reports


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    if name not in _LOADED:
        report = build([name])[name]
        _LOADED[name] = ctypes.CDLL(str(report.library))
    return _LOADED[name]
