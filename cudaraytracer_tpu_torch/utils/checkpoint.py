"""Fit checkpoints: parameters and the optimizer step saved as NPZ (the
port's own copy of the JAX package's ``utils/checkpoint.py``, same file
format, so a checkpoint written by either package loads in the other), and
the animation's resume point (``next_frame``).

Atomic writes (tmp + rename) so an interrupt never leaves a torn checkpoint.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_params(path: str, params: Dict[str, Any], step: int,
                extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomically save a dict of arrays or tensors (tuple values allowed)."""
    flat = {}
    for k, v in params.items():
        if isinstance(v, tuple):
            for i, vi in enumerate(v):
                flat[f"{k}.{i}"] = _np(vi)
        else:
            flat[k] = _np(v)
    meta = {"step": int(step), "keys": list(params.keys()),
            "extra": extra or {}}
    tmp = path + ".tmp"
    np.savez(tmp, __meta__=json.dumps(meta), **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_params(path: str) -> Tuple[Dict[str, Any], int, Dict[str, Any]]:
    """Load (params of numpy arrays, step, extra); raises
    FileNotFoundError if absent."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        params: Dict[str, Any] = {}
        for k in meta["keys"]:
            if k in z:
                params[k] = z[k]
            else:  # tuple-valued entry
                parts = sorted((n for n in z.files if n.startswith(k + ".")),
                               key=lambda n: int(n.rsplit(".", 1)[1]))
                params[k] = tuple(z[p] for p in parts)
    return params, meta["step"], meta.get("extra", {})


def next_frame(out_dir: str, begin_frame: int = 0) -> int:
    """The first frame index from ``begin_frame`` on without a
    picture_<n>.png in ``out_dir``: where an animation resumes (the
    reference's manual beginFrame, kernel.cu:50-51, made automatic)."""
    if not os.path.isdir(out_dir):
        return begin_frame
    have = set()
    for name in os.listdir(out_dir):
        m = re.fullmatch(r"picture_(\d+)\.png", name)
        if m:
            have.add(int(m.group(1)))
    f = begin_frame
    while f in have:
        f += 1
    return f
