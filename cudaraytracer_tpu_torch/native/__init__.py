"""The native BVH builder (``bvh_builder.cpp``), loaded with ctypes.

The reference builds its BVH on the device (bvh.h:76-125); the port builds
it on the host, in C++ here or in numpy (``ops/bvh.py``), and the card only
refits and traverses the flat arrays.  The shared library is compiled with
g++ at first use into the package's gitignored ``_build/`` directory, named
by a hash of the source and the flags, so an edited source is rebuilt.
``get_lib`` returns None when g++ is missing or fails; ``ops/bvh.py``
then builds in numpy under ``backend='auto'`` and raises under
``backend='native'``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
# -ffp-contract=off: no a * b + c contracted into one rounding, so the boxes
# round as the numpy builder's do
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
         "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libcrt_bvh_builder-{h.hexdigest()[:16]}.so"


def _compile(lib: Path) -> bool:
    # compile to a per-PID temporary file, then rename it atomically:
    # concurrent processes (parallel pytest workers, two apps on a cold
    # build) would otherwise write over each other's output
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run(["g++", *FLAGS, str(_SRC), "-o", str(tmp)],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if tmp.exists():
            tmp.unlink()


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library (built first if needed), or None when it cannot
    be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        if not lib_path.exists() and not _compile(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.crt_build_bvh.restype = ctypes.c_int32
        lib.crt_build_bvh.argtypes = [
            f32p, f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint32, f32p, f32p, u8p, i32p, i32p, i32p, i32p, i32p,
            i32p]
        _lib = lib
        return _lib


def build_bvh_native(prim_min: np.ndarray, prim_max: np.ndarray,
                     leaf_size: int = 2, axis_mode: str = "largest",
                     seed: int = 0):
    """Run the native builder -> (bbox_min, bbox_max, is_leaf, skip, prim0,
    prim1, child_l, child_r, depth) numpy arrays of the nodes, or None when
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    prim_min = np.ascontiguousarray(prim_min, np.float32)
    prim_max = np.ascontiguousarray(prim_max, np.float32)
    n = prim_min.shape[0]
    cap = max(2 * n, 1)
    bbox_min = np.empty((cap, 3), np.float32)
    bbox_max = np.empty((cap, 3), np.float32)
    is_leaf = np.empty(cap, np.uint8)
    skip, prim0, prim1, child_l, child_r, depth = (
        np.empty(cap, np.int32) for _ in range(6))
    n_nodes = lib.crt_build_bvh(
        prim_min.reshape(-1), prim_max.reshape(-1), n, leaf_size,
        1 if axis_mode == "random" else 0, seed, bbox_min.reshape(-1),
        bbox_max.reshape(-1), is_leaf, skip, prim0, prim1, child_l, child_r,
        depth)
    if n_nodes <= 0:
        return None
    s = slice(0, n_nodes)
    return (bbox_min[s], bbox_max[s], is_leaf[s].astype(bool), skip[s],
            prim0[s], prim1[s], child_l[s], child_r[s], depth[s])
