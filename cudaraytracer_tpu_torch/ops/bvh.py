"""Flattened BVH: host build, refit on the device, stackless traversal
(the JAX package's ``ops/bvh.py``).

The reference builds a pointer-based BVH on one device thread (bvh.h:76-125),
traverses it recursively (bvh.h:160-190) and refits it every frame for an
animated mesh (bvh.h:135-158 ``UpdateBVH``).  The port:

  * BUILD (host): recursive median split over the chosen axis, the
    reference's topology (sort prims by AABB min along the axis, BoxCompare
    bvh.h:9-45, split at n/2, leaves of 1-2 prims, bvh.h:95-109); the axis
    of the largest centroid extent by default, ``axis_mode='random'`` a
    seeded draw as the reference's curand axis (bvh.h:83-93).  Nodes in DFS
    preorder with SKIP LINKS, so traversal needs no stack: on a box hit go
    to node + 1, else to skip[node].  In numpy, or in C++
    (``native/bvh_builder.cpp``), with the same layout.

  * REFIT (device, plain tensor ops): leaf boxes from the current triangle
    vertices (a gather and a min / max), then each internal level, deepest
    first, as the union of its children: about 2 log2(T) small ops a frame.
    Min and max are exact, so the card's refit equals the CPU's bit for bit.

  * TRAVERSAL: ``traverse_bvh`` launches ``crt_bvh_traverse``
    (``csrc/bvh.cu``, one thread per ray walking the skip links) on a CUDA
    tensor and runs ``traverse_bvh_plain`` (JAX's lock-step loop of
    ``ops/bvh.py:296-356`` in torch) on a CPU tensor.  Per step a ray makes
    one slab test (aabb.h:30-43, the strict ``t_max <= t_min`` miss, NaN a
    miss) and, at a leaf, its one or two triangle tests, the first strictly
    smaller t winning.

Parity note: the reference BVH passes the caller's [t_min, t_max] down the
whole tree (no shrinking by the closest hit so far, bvh.h:160-190), which
interacts with the triangle no-t-clip quirk.  ``shrink=False`` (the default
under that quirk) walks every box the ray crosses; ``shrink=True`` prunes
with the running best t.
"""

from __future__ import annotations

import ctypes
import sys
import weakref
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Quirks
from ..core.device import resolve_device
from ..core.rays import Rays
from . import _cuda
from . import sweeps as _sw
from .sweeps import BIG, TRI_EPSILON, _f32

Tensor = torch.Tensor

# Boxes are padded by this margin at build and refit.  The reference's
# strict slab test (aabb.h:41 `t_max <= t_min` => miss) culls axis-aligned
# (zero-thickness) geometry; padding only ever ADDS candidate triangle
# tests.  It is absolute: at a mesh 1,000 units wide it is about 1.6 ulp.
AABB_PAD = 1e-4

# kernel launches of crt_bvh_traverse (the counting instance not included)
LAUNCHES = {"bvh_traverse": 0}

# csrc/bvh.cu's mode bits
M_SHRINK, M_BACK_CULLING, M_BACKFACE_ONLY, M_NO_T_CLIP, M_COUNT = (
    1, 2, 4, 8, 16)
# the plain walk drops the rays that reached the end of the tree every
# this many steps
COMPACT_EVERY = 8


def reset_launch_counts() -> None:
    LAUNCHES["bvh_traverse"] = 0


class FlatBVH(NamedTuple):
    bbox_min: Tensor    # float32[N, 3]
    bbox_max: Tensor    # float32[N, 3]
    is_leaf: Tensor     # bool[N]
    skip: Tensor        # int32[N]: the next node when this subtree is done
    prim0: Tensor       # int32[N]: leaf: first prim id; internal: -1
    prim1: Tensor       # int32[N]: leaf: second prim id (== prim0 if one)
    # refit metadata (static per topology):
    levels: Tuple[Tensor, ...]  # int32 ids of the INTERNAL nodes of each
                                # depth, deepest first
    child_l: Tensor     # int32[N]: internal: left child (node + 1); leaf -1
    child_r: Tensor     # int32[N]: internal: right child; leaf -1

    @property
    def n_nodes(self) -> int:
        return self.bbox_min.shape[0]


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------

def _levels_from_depth(depth_arr: np.ndarray, leaf_arr: np.ndarray) -> list:
    """The internal nodes of each depth, deepest first (the refit order)."""
    levels = []
    if len(depth_arr) == 0:
        return levels
    for d in range(int(depth_arr.max()), -1, -1):
        ids = np.nonzero((depth_arr == d) & ~leaf_arr)[0]
        if len(ids):
            levels.append(ids.astype(np.int32))
    return levels


def flat_bvh(bb_min, bb_max, is_leaf, skip, prim0, prim1, levels, child_l,
             child_r, device) -> FlatBVH:
    """A FlatBVH of numpy arrays' copies on ``device``."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    i32 = np.int32
    return FlatBVH(t(bb_min, np.float32), t(bb_max, np.float32),
                   t(is_leaf, np.bool_), t(skip, i32), t(prim0, i32),
                   t(prim1, i32), tuple(t(ids, i32) for ids in levels),
                   t(child_l, i32), t(child_r, i32))


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray,
              axis_mode: str = "largest", seed: int = 0,
              leaf_size: int = 2, backend: str = "auto",
              device=None) -> FlatBVH:
    """Build from per-primitive AABBs on the host -> FlatBVH on ``device``
    (default: the card).

    Topology as bvh.h:76-125: sort the span by box min along the chosen
    axis, split at n/2, spans of <= leaf_size become leaves.

    backend: 'auto' takes the native C++ builder (``native/``) when it
    builds and loads, else the Python one; 'python' and 'native' force one
    ('native' raises when the library does not build).  Both emit the same
    layout for the deterministic axis mode.  axis_mode='random' draws axes
    from each backend's own generator (numpy's or mt19937), so 'auto' pins
    it to the Python builder, as the JAX package does."""
    device = resolve_device(device)
    prim_min = np.asarray(prim_min, np.float32)
    prim_max = np.asarray(prim_max, np.float32)
    if leaf_size > 2:
        # leaves hold (and traversal tests) exactly two prim slots
        # (prim0 / prim1, bvh.h:95-109): a wider leaf would drop its middle
        raise ValueError(f"leaf_size must be 1 or 2, got {leaf_size}: "
                         "FlatBVH leaves hold at most two primitives")
    if axis_mode == "random" and backend == "auto":
        backend = "python"
    if backend in ("auto", "native"):
        from ..native import build_bvh_native
        out = build_bvh_native(prim_min, prim_max, leaf_size=leaf_size,
                               axis_mode=axis_mode, seed=seed)
        if out is not None:
            bb_min, bb_max, leaf_arr, skip, p0, p1, cl, cr, depth = out
            return flat_bvh(bb_min, bb_max, leaf_arr, skip, p0, p1,
                            _levels_from_depth(depth, leaf_arr), cl, cr,
                            device)
        if backend == "native":
            raise RuntimeError("the native BVH builder did not build or "
                               "load (g++ and native/bvh_builder.cpp)")
    elif backend != "python":
        raise ValueError(f"backend={backend!r}: expected 'auto', 'python' "
                         "or 'native'")
    n = prim_min.shape[0]
    if n < 1:
        raise ValueError("a BVH needs at least one primitive")
    rng = np.random.default_rng(seed)
    centroids = 0.5 * (prim_min + prim_max)

    # nodes in DFS preorder
    bb_min: List[np.ndarray] = []
    bb_max: List[np.ndarray] = []
    is_leaf: List[bool] = []
    prim0: List[int] = []
    prim1: List[int] = []
    child_l: List[int] = []
    child_r: List[int] = []
    depth_of: List[int] = []

    def emit(span: np.ndarray, depth: int) -> int:
        idx = len(is_leaf)
        bb_min.append(prim_min[span].min(axis=0) - AABB_PAD)
        bb_max.append(prim_max[span].max(axis=0) + AABB_PAD)
        depth_of.append(depth)
        if len(span) <= leaf_size:
            is_leaf.append(True)
            prim0.append(int(span[0]))
            prim1.append(int(span[-1]))   # == span[0] for a single prim
            child_l.append(-1)
            child_r.append(-1)
            return idx
        if axis_mode == "random":
            axis = int(rng.integers(0, 3))     # bvh.h:83 curand axis
        else:
            axis = int(np.argmax(centroids[span].max(0)
                                 - centroids[span].min(0)))
        # BoxCompare (bvh.h:9-45) sorts by the box MIN along the axis
        span = span[np.argsort(prim_min[span, axis], kind="stable")]
        is_leaf.append(False)
        prim0.append(-1)
        prim1.append(-1)
        child_l.append(-1)                     # set below
        child_r.append(-1)
        half = len(span) // 2                  # bvh.h:111-112 n/2 split
        child_l[idx] = emit(span[:half], depth + 1)
        child_r[idx] = emit(span[half:], depth + 1)
        return idx

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * int(np.ceil(np.log2(n + 1))) + 1000))
    try:
        emit(np.arange(n), 0)
    finally:
        sys.setrecursionlimit(old)

    n_nodes = len(is_leaf)
    skip = np.zeros(n_nodes, np.int32)

    def fill_skip(idx: int, after: int) -> None:
        skip[idx] = after
        if not is_leaf[idx]:
            fill_skip(child_l[idx], child_r[idx])
            fill_skip(child_r[idx], after)

    fill_skip(0, n_nodes)
    leaf_arr = np.asarray(is_leaf)
    return flat_bvh(np.stack(bb_min), np.stack(bb_max), leaf_arr, skip,
                    prim0, prim1,
                    _levels_from_depth(np.asarray(depth_of), leaf_arr),
                    child_l, child_r, device)


def triangle_bounds(v0, v1, v2):
    """Triangle AABBs (triangle.h:103-115 bounding_box), numpy."""
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    return lo, hi


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def build_triangle_bvh(v0, v1, v2, **kw) -> FlatBVH:
    """build_bvh over the triangles' bounds (numpy arrays or tensors)."""
    lo, hi = triangle_bounds(_host(v0), _host(v1), _host(v2))
    return build_bvh(lo, hi, **kw)


# ---------------------------------------------------------------------------
# Refit (UpdateBVH, bvh.h:135-158, a level at a time)
# ---------------------------------------------------------------------------

def refit_bvh(bvh: FlatBVH, v0: Tensor, v1: Tensor, v2: Tensor) -> FlatBVH:
    """All node boxes for the current triangle vertices (on the BVH's
    device): each leaf the union of its (<= 2) triangles' bounds padded by
    AABB_PAD, each internal level the union of its children, deepest level
    first.  Topology tensors are shared with ``bvh``."""
    tri_lo = torch.minimum(torch.minimum(v0, v1), v2) - AABB_PAD
    tri_hi = torch.maximum(torch.maximum(v0, v1), v2) + AABB_PAD
    p0 = bvh.prim0.clamp(min=0).long()
    p1 = bvh.prim1.clamp(min=0).long()
    leaf = bvh.is_leaf[:, None]
    lo = torch.where(leaf, torch.minimum(tri_lo[p0], tri_lo[p1]),
                     bvh.bbox_min)
    hi = torch.where(leaf, torch.maximum(tri_hi[p0], tri_hi[p1]),
                     bvh.bbox_max)
    for ids in bvh.levels:            # deepest internal level first
        ids = ids.long()
        left, right = bvh.child_l[ids].long(), bvh.child_r[ids].long()
        lo[ids] = torch.minimum(lo[left], lo[right])
        hi[ids] = torch.maximum(hi[left], hi[right])
    return bvh._replace(bbox_min=lo, bbox_max=hi)


# ---------------------------------------------------------------------------
# Traversal: the plain version
# ---------------------------------------------------------------------------

def _slab(lo: Tensor, hi: Tensor, o: Tensor, inv: Tensor, t_min: Tensor,
          prune: Tensor) -> Tensor:
    """aabb.h:30-43: strict `t_max <= t_min` => miss; NaN (0 * inf, an
    axis-parallel ray whose origin lies on a box plane) propagates through
    every min and max and misses the box."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(torch.maximum(
        near[:, 0], near[:, 1]), near[:, 2]), t_min)
    tmax = torch.minimum(torch.minimum(torch.minimum(
        far[:, 0], far[:, 1]), far[:, 2]), prune)
    return tmax > tmin


def _tri_test(o: Tensor, d: Tensor, a0: Tensor, a1: Tensor, a2: Tensor,
              nrm: Tensor, prune: Tensor, quirks: Quirks, t_min: float):
    """One triangle per ray, Moller-Trumbore with the quirk gates of
    triangle.h:57-100 (JAX ``_tri_test``, bvh.py:269-293) in the kernel's
    order of operations -> (valid, t)."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    e1 = a1 - a0
    e2 = a2 - a0
    e1x, e1y, e1z = e1.unbind(1)
    e2x, e2y, e2z = e2.unbind(1)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / a
    sx, sy, sz = ox - a0[:, 0], oy - a0[:, 1], oz - a0[:, 2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = ((a.abs() >= TRI_EPSILON) & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0))
    if quirks.triangle_back_culling:      # triangle.h:74
        valid &= a >= TRI_EPSILON
    if quirks.triangle_backface_only:
        valid &= (dx * nrm[:, 0] + dy * nrm[:, 1] + dz * nrm[:, 2]) >= 0.0
    if quirks.triangle_no_t_clip:
        valid &= t < prune
    else:
        valid &= (t > t_min) & (t < prune)
    return valid, t


def _shrink_of(quirks: Quirks, shrink: Optional[bool]) -> bool:
    return (not quirks.triangle_no_t_clip) if shrink is None else shrink


def traverse_bvh_plain(bvh: FlatBVH, v0: Tensor, v1: Tensor, v2: Tensor,
                       normal: Tensor, rays: Rays, t_min: float,
                       t_max: float, quirks: Quirks,
                       shrink: Optional[bool] = None,
                       alive: Optional[Tensor] = None):
    """Plain version of crt_bvh_traverse: JAX's lock-step loop
    (bvh.py:296-356) in torch -> (best_t float32[N], best_prim int32[N]),
    (BIG, -1) on a miss and on a dead lane.  Every COMPACT_EVERY steps
    the rays that reached the end of the tree leave the loop (each ray's
    arithmetic is its own, so this changes no result)."""
    shrink = _shrink_of(quirks, shrink)
    t_min, t_max = _f32(t_min), _f32(t_max)
    o_all, d_all = rays.origin, rays.direction
    n, dev = o_all.shape[0], o_all.device
    best_t = torch.full((n,), BIG, device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    n_nodes = bvh.n_nodes
    act = (torch.arange(n, device=dev) if alive is None
           else torch.nonzero(alive.bool()).flatten())
    if n_nodes == 0 or act.numel() == 0:
        return best_t, best_p
    tmin_t = torch.tensor(t_min, device=dev)
    tmax_t = torch.tensor(t_max, device=dev)
    o, d = o_all[act], d_all[act]
    inv = 1.0 / d
    node = torch.zeros(act.shape[0], dtype=torch.int64, device=dev)
    bt = torch.full((act.shape[0],), BIG, device=dev)
    bp = torch.full((act.shape[0],), -1, dtype=torch.int32, device=dev)
    skip = bvh.skip.long()
    p0_all, p1_all = bvh.prim0.long(), bvh.prim1.long()
    step = 0
    while act.numel():
        # a ray past the last node idles until the next compaction
        active = node < n_nodes
        nid = node.clamp(max=n_nodes - 1)
        prune = torch.minimum(bt, tmax_t) if shrink else tmax_t.expand_as(bt)
        box = _slab(bvh.bbox_min[nid], bvh.bbox_max[nid], o, inv, tmin_t,
                    prune) & active
        leaf = bvh.is_leaf[nid]
        li = torch.nonzero(box & leaf).flatten()
        if li.numel():
            nl = nid[li]
            p0, p1 = p0_all[nl], p1_all[nl]
            ol, dl, pl = o[li], d[li], prune[li]
            bt_l, bp_l = bt[li], bp[li]
            val0, t0 = _tri_test(ol, dl, v0[p0], v1[p0], v2[p0], normal[p0],
                                 pl, quirks, t_min)
            val1, t1 = _tri_test(ol, dl, v0[p1], v1[p1], v2[p1], normal[p1],
                                 pl, quirks, t_min)
            # a leaf's prims in list order: the first strictly smaller wins
            take0 = val0 & (t0 < bt_l)
            bt_l = torch.where(take0, t0, bt_l)
            bp_l = torch.where(take0, p0.to(torch.int32), bp_l)
            take1 = val1 & (p1 != p0) & (t1 < bt_l)
            bt[li] = torch.where(take1, t1, bt_l)
            bp[li] = torch.where(take1, p1.to(torch.int32), bp_l)
        node = torch.where(active, torch.where(box & ~leaf, nid + 1,
                                               skip[nid]), node)
        step += 1
        if step % COMPACT_EVERY == 0:
            done = node >= n_nodes
            if bool(done.any()):
                best_t[act[done]] = bt[done]
                best_p[act[done]] = bp[done]
                keep = ~done
                act, o, inv, d = act[keep], o[keep], inv[keep], d[keep]
                node, bt, bp = node[keep], bt[keep], bp[keep]
    return best_t, best_p


# ---------------------------------------------------------------------------
# Traversal: the kernel
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _cuda.load("bvh")
    if not getattr(lib, "_crt_declared", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.crt_bvh_traverse.argtypes = ([vp] * 18 + [ci] * 3 + [cf] * 2
                                         + [vp])
        lib.crt_bvh_traverse.restype = ci
        lib.crt_bvh_error_string.argtypes = [ci]
        lib.crt_bvh_error_string.restype = ctypes.c_char_p
        lib._crt_declared = True
    return lib


def mode_of(quirks: Quirks, shrink: bool, count: bool = False) -> int:
    """csrc/bvh.cu's instance for these quirks (its template modes)."""
    return ((M_SHRINK if shrink else 0)
            | (M_BACK_CULLING if quirks.triangle_back_culling else 0)
            | (M_BACKFACE_ONLY if quirks.triangle_backface_only else 0)
            | (M_NO_T_CLIP if quirks.triangle_no_t_clip else 0)
            | (M_COUNT if count else 0))


def _check_cuda(name: str, x: Tensor, dtype, shape, device) -> None:
    if not x.is_cuda or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor; "
                         f"got {x.dtype} on {x.device}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, rays on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")


# the largest prim id of each BVH topology seen, read once (a launch must
# not index past the triangle tables): id of its prim1 tensor, which
# refit_bvh shares -> (a weak reference to that tensor, the id)
_PRIM_MAX: dict = {}


def _prim_max(bvh: FlatBVH) -> int:
    hit = _PRIM_MAX.get(id(bvh.prim1))
    if hit is not None and hit[0]() is bvh.prim1:
        return hit[1]
    for k in [k for k, (ref, _) in _PRIM_MAX.items() if ref() is None]:
        del _PRIM_MAX[k]
    m = int(torch.maximum(bvh.prim0.max(), bvh.prim1.max()))
    _PRIM_MAX[id(bvh.prim1)] = (weakref.ref(bvh.prim1), m)
    return m


class BVHCounts(NamedTuple):
    """What the counting instance writes: each ray's box and triangle
    tests, and which nodes and triangles any ray tested."""
    ray_tests: Tensor   # int32[2, R]: box tests, triangle tests
    node_seen: Tensor   # uint8[N]
    tri_seen: Tensor    # uint8[T]


def launch_bvh_traverse(bvh: FlatBVH, v0: Tensor, v1: Tensor, v2: Tensor,
                        normal: Tensor, origin: Tensor, direction: Tensor,
                        t_min: float, t_max: float, quirks: Quirks,
                        shrink: bool, alive: Optional[Tensor] = None,
                        counts: Optional[BVHCounts] = None):
    """One launch of crt_bvh_traverse -> (best_t float32[N], best_prim
    int32[N]).  counts: a BVHCounts of zeroed CUDA tensors that the
    counting instance fills (measurement only; not a main-path launch)."""
    n = origin.shape[0]
    dev = origin.device
    n_nodes, n_tri = bvh.n_nodes, v0.shape[0]
    _check_cuda("origin", origin, torch.float32, (n, 3), dev)
    _check_cuda("direction", direction, torch.float32, (n, 3), dev)
    if alive is not None:
        _check_cuda("alive", alive, torch.bool, (n,), dev)
    for name, x in (("v0", v0), ("v1", v1), ("v2", v2), ("normal", normal)):
        _check_cuda(name, x, torch.float32, (n_tri, 3), dev)
    for name, x, dtype, shape in (
            ("bbox_min", bvh.bbox_min, torch.float32, (n_nodes, 3)),
            ("bbox_max", bvh.bbox_max, torch.float32, (n_nodes, 3)),
            ("is_leaf", bvh.is_leaf, torch.bool, (n_nodes,)),
            ("skip", bvh.skip, torch.int32, (n_nodes,)),
            ("prim0", bvh.prim0, torch.int32, (n_nodes,)),
            ("prim1", bvh.prim1, torch.int32, (n_nodes,))):
        _check_cuda(name, x, dtype, shape, dev)
    if counts is not None:
        _check_cuda("ray_tests", counts.ray_tests, torch.int32, (2, n), dev)
        _check_cuda("node_seen", counts.node_seen, torch.uint8, (n_nodes,),
                    dev)
        _check_cuda("tri_seen", counts.tri_seen, torch.uint8, (n_tri,), dev)
    if n >= 2 ** 31 or n_nodes >= 2 ** 31:
        raise ValueError(f"{n} rays or {n_nodes} nodes exceed one launch")
    if n_nodes and _prim_max(bvh) >= n_tri:
        raise ValueError(f"the BVH holds prim {_prim_max(bvh)}, the "
                         f"triangle tables {n_tri} rows")
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_i = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _library()

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        code = lib.crt_bvh_traverse(
            origin.data_ptr(), direction.data_ptr(), bvh.bbox_min.data_ptr(),
            bvh.bbox_max.data_ptr(), bvh.skip.data_ptr(),
            bvh.prim0.data_ptr(), bvh.prim1.data_ptr(),
            bvh.is_leaf.data_ptr(), v0.data_ptr(), v1.data_ptr(),
            v2.data_ptr(), normal.data_ptr(), ptr(alive), out_t.data_ptr(),
            out_i.data_ptr(),
            ptr(counts.ray_tests if counts is not None else None),
            ptr(counts.node_seen if counts is not None else None),
            ptr(counts.tri_seen if counts is not None else None),
            n, n_nodes, mode_of(quirks, shrink, counts is not None),
            _f32(t_min), _f32(t_max),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError("bvh_traverse launch failed: "
                           f"{lib.crt_bvh_error_string(code).decode()}")
    if counts is None:
        LAUNCHES["bvh_traverse"] += 1
    return out_t, out_i


def traverse_bvh(bvh: FlatBVH, v0: Tensor, v1: Tensor, v2: Tensor,
                 normal: Tensor, rays: Rays, t_min: float, t_max: float,
                 quirks: Quirks, shrink: Optional[bool] = None,
                 alive: Optional[Tensor] = None):
    """Closest triangle hit through the BVH (bvh.py:296 of the JAX package)
    -> (best_t float32[N], best_prim int32[N]); best_prim -1 on a miss and
    on a dead lane (``alive`` false).  shrink None: from the quirks (no
    shrinking under the no-t-clip quirk, as bvh.h passes the caller's t
    range unchanged).  A CUDA tensor launches crt_bvh_traverse, a CPU one
    runs the plain version; no result carries a gradient."""
    origin = rays.origin
    if origin.device.type == "cpu":
        return traverse_bvh_plain(bvh, v0, v1, v2, normal, rays, t_min,
                                  t_max, quirks, shrink, alive)
    if origin.device.type != "cuda":
        raise ValueError(f"traverse_bvh runs on CUDA or CPU tensors, not "
                         f"{origin.device}")

    def c(x):
        return x.detach().contiguous()

    return launch_bvh_traverse(
        bvh, c(v0), c(v1), c(v2), c(normal), c(origin), c(rays.direction),
        t_min, t_max, quirks, _shrink_of(quirks, shrink),
        None if alive is None else alive.bool().contiguous())


class _BVHBestHit(_sw._TriangleBestHit):
    """traverse_bvh with t differentiable: the backward of the triangle
    sweep (K4's), which recomputes only each ray's winner."""

    @staticmethod
    def forward(ctx, origin, direction, v0, v1, v2, normal, t_min, t_max,
                quirks, alive, walk):
        bvh, shrink = walk
        t, idx = traverse_bvh(bvh, v0, v1, v2, normal,
                              Rays(origin, direction, origin.new_zeros(0)),
                              t_min, t_max, quirks, shrink, alive)
        ctx.save_for_backward(origin, direction, v0, v1, v2, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx


def bvh_best_hit(bvh: FlatBVH, v0: Tensor, v1: Tensor, v2: Tensor,
                 normal: Tensor, rays: Rays, t_min: float, t_max: float,
                 quirks: Quirks, shrink: Optional[bool] = None,
                 alive: Optional[Tensor] = None):
    """traverse_bvh whose t carries gradients to the rays and to the
    winners' vertices (the normal and the ids get none)."""
    return _BVHBestHit.apply(rays.origin, rays.direction, v0, v1, v2, normal,
                             t_min, t_max, quirks, alive, (bvh, shrink))
