"""Per-bone BVH forest (hitable/BoneBVH.h; the JAX package's
``ops/bone_bvh.py``).

The reference's alternative dynamic-scene structure builds ONE BVH PER
SKELETON BONE over the triangles fully weighted to that bone
(createScene.h:253-306), keeps leaf boxes in bone space and refits each
frame with the bone's translation, one bone per CUDA thread
(createScene.h:60-96).  That round trip into bone space and back is the
identity: the leaf refit reads the current skinned world-space triangle
bounds (BoneBVH.h:105-133), so the forest here stays in WORLD space:

  * triangles are partitioned by bone with the reference's rule
    (createScene.h:262-288): a triangle belongs to bone b when all three of
    its vertices carry a weight of b; bones claim triangles first come,
    first served, in cluster order; unclaimed triangles are DROPPED, as in
    the reference (``orphans='keep'`` gathers them under one more tree);
  * one flat BVH per bone, CONCATENATED: DFS layouts with skip links
    compose (each tree's exit skip lands on the next tree's root), so the
    forest traverses (the one kernel, ``ops/bvh.py``) and refits (every
    bone at once) as a single BVH.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from ..core.device import resolve_device
from .bvh import FlatBVH, build_bvh, flat_bvh, triangle_bounds


class BoneForest(NamedTuple):
    bvh: FlatBVH              # the concatenated forest: traverse / refit it
    bone_of_tri: np.ndarray   # int32[T] bone of each triangle (-1: orphan)
    root_offsets: np.ndarray  # int32[trees] node offset of each tree
    root_bones: np.ndarray    # int32[trees] bone of each tree (-1: orphans)
    n_dropped: int            # orphan triangles in no tree


def partition_by_bone(weights: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """createScene.h:262-288: the first bone (cluster order) whose weight
    set holds ALL THREE vertices claims the triangle -> int32[T] bone ids,
    -1 where none does (a mesh with no bones: every triangle)."""
    has_weight = np.asarray(weights) > 0.0                   # (P, B)
    faces = np.asarray(faces)
    if has_weight.shape[1] == 0:
        return np.full(len(faces), -1, np.int32)
    tri_covered = has_weight[faces].all(axis=1)              # (T, B)
    first = np.argmax(tri_covered, axis=1).astype(np.int32)
    return np.where(tri_covered.any(axis=1), first, -1).astype(np.int32)


def build_bone_forest(v0, v1, v2, weights: np.ndarray, faces: np.ndarray,
                      orphans: str = "drop", device=None,
                      **bvh_kw) -> BoneForest:
    """The forest of the triangles (v0, v1, v2 float32[T, 3], the pose to
    build in) under skin ``weights`` float32[P, B] of ``faces`` int[T, 3],
    on ``device`` (default: the card).  bvh_kw: build_bvh's axis_mode,
    seed, leaf_size, backend."""
    device = resolve_device(device)
    v0, v1, v2 = (np.asarray(x, np.float32) for x in (v0, v1, v2))
    bone_of_tri = partition_by_bone(weights, faces)
    lo, hi = triangle_bounds(v0, v1, v2)
    groups: List[np.ndarray] = []
    group_bones: List[int] = []
    for b in range(np.asarray(weights).shape[1]):
        tris = np.nonzero(bone_of_tri == b)[0]
        if len(tris):                     # an empty bone has no tree
            groups.append(tris)
            group_bones.append(b)
    orphan_ids = np.nonzero(bone_of_tri < 0)[0]
    n_dropped = len(orphan_ids)
    if orphans == "keep" and n_dropped:
        groups.append(orphan_ids)
        group_bones.append(-1)
        n_dropped = 0
    elif orphans not in ("drop", "keep"):
        raise ValueError(f"orphans={orphans!r}: expected 'drop' or 'keep'")
    trees = [build_bvh(lo[g], hi[g], device="cpu", **bvh_kw) for g in groups]
    forest = concatenate_bvhs(trees, groups, device)
    offsets = (np.cumsum([0] + [t.n_nodes for t in trees[:-1]]).astype(
        np.int32) if trees else np.zeros(0, np.int32))
    return BoneForest(forest, bone_of_tri, offsets,
                      np.asarray(group_bones, np.int32), n_dropped)


def concatenate_bvhs(trees: List[FlatBVH], prim_maps: List[np.ndarray],
                     device=None) -> FlatBVH:
    """Concatenate skip-link BVHs into one walkable forest on ``device``
    (default: the card).

    Node ids and skip links shift by each tree's offset; a tree's exit skip
    (its node count) then points at the next tree's root, so one traversal
    walks every tree in turn.  prim_maps[i] maps tree i's local prim ids to
    global triangle ids."""
    if not trees:
        raise ValueError(
            "empty bone forest: no triangle had all three vertices inside "
            "any single bone's weight set (densely blended or unskinned "
            "mesh) and orphans were dropped: use the plain BVH or "
            "megakernel pipeline for this mesh, or orphans='keep'")
    device = resolve_device(device)
    offset = 0
    cols = {k: [] for k in ("bb_min", "bb_max", "is_leaf", "skip", "p0",
                            "p1", "cl", "cr")}
    level_groups = {}
    for tree, pmap in zip(trees, prim_maps):
        host = {k: getattr(tree, k).cpu().numpy() for k in (
            "bbox_min", "bbox_max", "is_leaf", "skip", "prim0", "prim1",
            "child_l", "child_r")}
        pmap = np.asarray(pmap, np.int32)
        cols["bb_min"].append(host["bbox_min"])
        cols["bb_max"].append(host["bbox_max"])
        cols["is_leaf"].append(host["is_leaf"])
        cols["skip"].append(host["skip"] + offset)
        for k, name in (("p0", "prim0"), ("p1", "prim1")):
            lp = host[name]
            cols[k].append(np.where(lp >= 0, pmap[np.maximum(lp, 0)], -1))
        for k, name in (("cl", "child_l"), ("cr", "child_r")):
            lc = host[name]
            cols[k].append(np.where(lc >= 0, lc + offset, -1))
        for d, ids in enumerate(tree.levels):     # deepest first per tree
            # keyed by the position in the tree's OWN deepest-first order:
            # within a tree, level d's children all lie in levels < d, and
            # trees are independent, so merging by d and refitting in
            # ascending d keeps every child before its parent
            level_groups.setdefault(d, []).append(ids.cpu().numpy() + offset)
        offset += tree.n_nodes
    levels = [np.concatenate(level_groups[k]) for k in sorted(level_groups)]
    cat = {k: np.concatenate(v) for k, v in cols.items()}
    return flat_bvh(cat["bb_min"], cat["bb_max"], cat["is_leaf"],
                    cat["skip"], cat["p0"], cat["p1"], levels, cat["cl"],
                    cat["cr"], device)
