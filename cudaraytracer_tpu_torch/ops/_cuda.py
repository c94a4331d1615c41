"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is built from its sources under ``csrc/`` (one object per
source, every source of every library compiled by its own nvcc, all started
together, then one link per library) into a shared library with a plain C
interface, at first use, into ``_build/`` next to this package (listed in
.gitignore) and named by a hash of its sources, the headers and the flags,
so an edited source is rebuilt and an unchanged one is reused.  There is
no fallback: without nvcc or a card, building or loading raises.
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
CSRC = PACKAGE_DIR / "csrc"
# The megakernel's instances are split over five translation units, so
# that they compile in parallel (csrc/megakernel.cuh).
SOURCES = {"megakernel": [CSRC / f"{n}.cu" for n in (
               "megakernel", "megakernel_coop", "megakernel_mxu",
               "megakernel_path", "megakernel_path_f2b")],
           "sweeps": [CSRC / "sweeps.cu"],
           "bvh": [CSRC / "bvh.cu"]}
BUILD_DIR = PACKAGE_DIR / "_build"
# --fmad=false: no contraction of a * b + c into one rounding, so the kernels
# round like their plain PyTorch versions (see csrc/megakernel.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildReport:
    name: str
    library: Path
    seconds: float      # 0.0 when an earlier build was reused; else from
                        # the first compile's start to the link's end
    ptxas: str          # nvcc's -Xptxas -v report (registers, spills)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); the "
                       "port's CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(proc: subprocess.Popen, what) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what}:\n{out}")
    return out


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, BuildReport]:
    """Compile the named libraries' sources, one nvcc process each, all
    started together, then link each library.  Raises with nvcc's output if
    any step fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports: Dict[str, BuildReport] = {}
    t0 = time.perf_counter()
    running = {}
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            reports[name] = BuildReport(name, lib, 0.0, "(reused)")
            continue
        tag = f"{lib.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES[name]]
        procs = [(_run([nvcc_path(), *NVCC_FLAGS, "-c", "-o", obj, src]), src)
                 for src, obj in zip(SOURCES[name], objs)]
        running[name] = (procs, objs, lib)
    for name, (procs, objs, lib) in running.items():
        out = "".join(_wait(p, src) for p, src in procs)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        _wait(_run([nvcc_path(), "-shared", "-o", tmp, *objs]), lib.name)
        os.replace(tmp, lib)
        for obj in objs:
            obj.unlink()
        reports[name] = BuildReport(name, lib, time.perf_counter() - t0, out)
    return reports


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    if name not in _LOADED:
        report = build([name])[name]
        _LOADED[name] = ctypes.CDLL(str(report.library))
    return _LOADED[name]
