"""FBX semantic loader: mesh + skin + animation, no Autodesk SDK (the
port's own copy of the JAX package's ``utils/fbx_loader.py``: pure Python
and numpy, the same arrays from the same file).

From-scratch reimplementation of the reference's FBX pipeline
(CudaTest/src/Loader/FbxLoader.h) on top of the binary container parser
(fbx_parser.py):

  load_skinned_mesh == CreateFBXData (FbxLoader.h:185-214):
    * GetMeshData   (:11-65)  — control points, fan-triangulated polygon
      indices, one normal per triangle (GetPolygonVertexNormal(poly, 0)
      equivalent: the normal at the polygon's first polygon-vertex).
    * GetBoneData   (:67-103) — per-cluster weight indices/weights + the
      bone's default global T/R (EvaluateGlobalTransform at bind defaults).
    * GetAnimationData (:105-183) — samples the skeleton at 60 fps
      (FbxTime::eFrames60, :113) over the take's LocalTime span and computes
      per-bone vertex-transform matrices
        vT = globalPos^-1 · clusterGlobalCurrent · clusterGlobalInit^-1 · refGlobalInit
      exactly as :151-163.  Unlike the reference (which expands these into a
      per-POINT matrix per frame on the host), we keep the compact
      (frames, bones, 4, 4) tensor and defer the weighted blend to one
      matmul on the device (models/mesh.py).

  Transform evaluation replaces EvaluateGlobalTransform: world = parent_world
  @ T·Roff·Rpiv·PreR·R·PostR^-1·Rpiv^-1·Soff·Spiv·S·Spiv^-1 (column-vector
  convention; FBX files store the transpose).  Rotation order honors the
  RotationOrder property (default XYZ = apply X first).  Animation curves are
  sampled with linear key interpolation (Mixamo-style baked exports have a key
  per frame, so higher-order interpolation is immaterial).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .fbx_parser import (KTIME_PER_SECOND, FbxNode, get_prop70, get_vec3_prop,
                         parse_fbx)

# FbxTime::eFrames60 (FbxLoader.h:113)
ONE_FRAME_60FPS = KTIME_PER_SECOND // 60


# ---------------------------------------------------------------------------
# Matrix helpers (column-vector convention: p' = M @ [p;1])
# ---------------------------------------------------------------------------

def _rot_axis(angle_deg: float, axis: int) -> np.ndarray:
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    if axis == 1:
        m[i, j] = s
        m[j, i] = -s
    else:
        m[i, j] = -s
        m[j, i] = s
    return m


def euler_matrix(rot_deg, order: int = 0) -> np.ndarray:
    """Column-convention rotation for FBX RotationOrder enum.

    order 0 = eEulerXYZ (X applied first) ... 5 = eEulerZYX; column conv means
    first-applied goes rightmost in the product.
    """
    rx, ry, rz = (float(r) for r in rot_deg)
    mx, my, mz = _rot_axis(rx, 0), _rot_axis(ry, 1), _rot_axis(rz, 2)
    seqs = {  # application order (first..last), EFbxRotationOrder values:
        # 0 eEulerXYZ, 1 eEulerXZY, 2 eEulerYZX, 3 eEulerYXZ,
        # 4 eEulerZXY, 5 eEulerZYX
        0: (mx, my, mz), 1: (mx, mz, my), 2: (my, mz, mx),
        3: (my, mx, mz), 4: (mz, mx, my), 5: (mz, my, mx),
    }
    a, b, c = seqs.get(order, seqs[0])
    return c @ b @ a


def _translation(t) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = t
    return m


def _scaling(s) -> np.ndarray:
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def matrix_to_trs(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (translation, XYZ euler degrees) like FbxAMatrix GetT/GetR
    (FbxLoader.h:88-89, :176-177)."""
    t = m[:3, 3].copy()
    r = m[:3, :3]
    sx = np.linalg.norm(r[:, 0])
    sy = np.linalg.norm(r[:, 1])
    sz = np.linalg.norm(r[:, 2])
    rn = r / np.array([sx, sy, sz])
    # column-conv XYZ order (R = Rz @ Ry @ Rx)
    ry = math.asin(max(-1.0, min(1.0, -rn[2, 0])))
    if abs(rn[2, 0]) < 0.99999:
        rx = math.atan2(rn[2, 1], rn[2, 2])
        rz = math.atan2(rn[1, 0], rn[0, 0])
    else:
        rx = math.atan2(-rn[1, 2], rn[1, 1])
        rz = 0.0
    return t, np.degrees([rx, ry, rz])


# ---------------------------------------------------------------------------
# Scene graph
# ---------------------------------------------------------------------------

@dataclass
class FbxModel:
    uid: int
    name: str
    cls: str
    node: FbxNode
    parent: Optional["FbxModel"] = None
    # animated channels: name -> {'X': (times, values), ...}
    curves: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]] = field(default_factory=dict)

    def prop_vec3(self, name, default=(0.0, 0.0, 0.0)):
        return get_vec3_prop(self.node, name, default)


def _clean_name(raw: str) -> str:
    return raw.split("\x00", 1)[0]


class FbxScene:
    """Parsed object graph with transform/animation evaluation."""

    def __init__(self, path: str):
        self.root = parse_fbx(path)
        objs = self.root.find("Objects")
        if objs is None:
            raise ValueError(f"{path}: no Objects node")
        self.by_id: Dict[int, FbxNode] = {}
        for c in objs.children:
            if c.props and isinstance(c.props[0], int):
                self.by_id[c.props[0]] = c

        conns = self.root.find("Connections")
        self.oo: List[Tuple[int, int]] = []            # (child, parent)
        self.op: List[Tuple[int, int, str]] = []       # (src, dst, prop)
        for c in (conns.find_all("C") if conns else []):
            if c.props[0] == "OO":
                self.oo.append((c.props[1], c.props[2]))
            elif c.props[0] == "OP":
                self.op.append((c.props[1], c.props[2], c.props[3]))

        self.models: Dict[int, FbxModel] = {}
        for uid, node in self.by_id.items():
            if node.name == "Model":
                self.models[uid] = FbxModel(uid, _clean_name(node.props[1]),
                                            node.props[2], node)
        # parents: a Model can have several OO connections (parent Model,
        # skin Cluster back-link, ...) — the scene-graph parent is the one
        # whose destination is another Model (or 0 = scene root).
        for uid, m in self.models.items():
            m.parent = None
            for child, parent in self.oo:
                if child == uid and (parent in self.models or parent == 0):
                    m.parent = self.models.get(parent)
                    break

        self._gt_cache: Dict[Tuple[int, Optional[int]], np.ndarray] = {}
        self._attach_animation()

    # -- animation wiring ------------------------------------------------
    def _attach_animation(self) -> None:
        """Wire AnimationCurve -> AnimationCurveNode channel -> Model property
        for the first animation stack (importer->GetTakeInfo(0) analog)."""
        curve_nodes = {uid: n for uid, n in self.by_id.items()
                       if n.name == "AnimationCurveNode"}
        curves = {uid: n for uid, n in self.by_id.items()
                  if n.name == "AnimationCurve"}
        # Restrict to the FIRST stack's first layer (file order == take 0):
        # multi-take files connect every take's curve nodes to the same model
        # properties, and an unfiltered last-write-wins can even mix channels
        # from different takes.
        stacks = [uid for uid, n in self.by_id.items()
                  if n.name == "AnimationStack"]
        layers = {uid for uid, n in self.by_id.items()
                  if n.name == "AnimationLayer"}
        allowed_cn: Optional[set] = None
        if len(stacks) > 1 or (stacks and len(layers) > 1):
            first_layers = [child for child, parent in self.oo
                            if parent == stacks[0] and child in layers]
            if first_layers:
                lay0 = first_layers[0]
                allowed_cn = {child for child, parent in self.oo
                              if parent == lay0 and child in curve_nodes}
        # channel curves attached to curve nodes
        node_channels: Dict[int, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {}
        for src, dst, prop in self.op:
            if src in curves and dst in curve_nodes:
                cn = curves[src]
                kt = cn.find("KeyTime")
                kv = cn.find("KeyValueFloat")
                if kt is None or kv is None:
                    continue
                ch = prop.split("|")[-1]  # 'd|X' -> 'X'
                node_channels.setdefault(dst, {})[ch] = (
                    np.asarray(kt.props[0], np.int64),
                    np.asarray(kv.props[0], np.float64))
        # curve nodes attached to model properties
        for src, dst, prop in self.op:
            if src in curve_nodes and dst in self.models:
                if allowed_cn is not None and src not in allowed_cn:
                    continue
                chans = node_channels.get(src)
                if chans:
                    self.models[dst].curves[prop] = chans

    # -- take span -------------------------------------------------------
    def take_span(self) -> Tuple[int, int]:
        takes = self.root.find("Takes")
        if takes:
            for t in takes.find_all("Take"):
                lt = t.find("LocalTime")
                if lt and len(lt.props) >= 2:
                    return int(lt.props[0]), int(lt.props[1])
        # fall back to AnimationStack LocalStop
        for n in self.by_id.values():
            if n.name == "AnimationStack":
                stop = get_prop70(n, "LocalStop", 0)
                return 0, int(stop)
        return 0, 0

    # -- transform evaluation -------------------------------------------
    def _eval_channel(self, model: FbxModel, prop: str, default, ktime: Optional[int]):
        """Value of an animatable vec3 property at KTime (linear key interp);
        None -> bind defaults (EvaluateGlobalTransform() with no time)."""
        base = np.asarray(model.prop_vec3(prop, default), np.float64)
        if ktime is None:
            return base
        chans = model.curves.get(prop)
        if not chans:
            return base
        out = base.copy()
        for i, ch in enumerate("XYZ"):
            if ch in chans:
                times, values = chans[ch]
                out[i] = np.interp(float(ktime), times.astype(np.float64), values)
        return out

    def local_transform(self, model: FbxModel, ktime: Optional[int]) -> np.ndarray:
        """FBX local transform chain (column conv):
        T · Roff · Rpiv · PreR · R · PostR^-1 · Rpiv^-1 · Soff · Spiv · S · Spiv^-1."""
        t = self._eval_channel(model, "Lcl Translation", (0, 0, 0), ktime)
        r = self._eval_channel(model, "Lcl Rotation", (0, 0, 0), ktime)
        s = self._eval_channel(model, "Lcl Scaling", (1, 1, 1), ktime)
        order = get_prop70(model.node, "RotationOrder", 0)
        order = int(order) if not isinstance(order, tuple) else 0

        roff = model.prop_vec3("RotationOffset")
        rpiv = model.prop_vec3("RotationPivot")
        soff = model.prop_vec3("ScalingOffset")
        spiv = model.prop_vec3("ScalingPivot")
        pre = model.prop_vec3("PreRotation")
        post = model.prop_vec3("PostRotation")

        m = _translation(t)
        m = m @ _translation(roff) @ _translation(rpiv)
        m = m @ euler_matrix(pre, 0)
        m = m @ euler_matrix(r, order)
        m = m @ np.linalg.inv(euler_matrix(post, 0))
        m = m @ _translation(-rpiv)
        m = m @ _translation(soff) @ _translation(spiv)
        m = m @ _scaling(s)
        m = m @ _translation(-spiv)
        return m

    def global_transform(self, model: Optional[FbxModel],
                         ktime: Optional[int]) -> np.ndarray:
        """EvaluateGlobalTransform analog (scene root == identity).

        Memoized per (uid, ktime): the per-frame extraction loop walks the
        root-to-bone chain for EVERY bone at EVERY frame, so without the
        cache a deep rig re-evaluates each ancestor's 10-matmul local chain
        O(frames x bones x depth) times."""
        if model is None:
            return np.eye(4)
        key = (model.uid, ktime)
        cached = self._gt_cache.get(key)
        if cached is None:
            cached = self.global_transform(model.parent, ktime) @ \
                self.local_transform(model, ktime)
            self._gt_cache[key] = cached
        return cached


# ---------------------------------------------------------------------------
# Mesh / skin / animation extraction
# ---------------------------------------------------------------------------

@dataclass
class SkinnedMesh:
    """The FBXObject analog (shapes/MeshObject.h:65-77) in SoA form."""

    points: np.ndarray          # f32[P,3] bind-pose control points
    faces: np.ndarray           # i32[T,3] triangulated control-point indices
    normals: np.ndarray         # f32[T,3] per-triangle loaded normals
    bone_names: List[str]
    weights: np.ndarray         # f32[P,B] dense LBS weights
    bone_default_t: np.ndarray  # f32[B,3] bind global translation (Bone ctor)
    bone_default_r: np.ndarray  # f32[B,3] bind global rotation
    frame_count: int
    vertex_transforms: np.ndarray  # f32[F,B,4,4] per-frame cluster matrices
    bone_now_t: np.ndarray      # f32[F,B,3] per-frame bone global T (BoneBVH)
    bone_now_r: np.ndarray      # f32[F,B,3]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.faces.shape[0]

    @property
    def n_bones(self) -> int:
        return len(self.bone_names)


def _triangulate(pvi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """PolygonVertexIndex -> (faces i32[T,3], poly_first_pv i32[T]).

    Negative index marks the last vertex of a polygon, encoded as ~idx
    (GetMeshData relies on the SDK's Triangulate; we fan-triangulate, which
    matches the SDK's output for convex polygons).  poly_first_pv is the flat
    polygon-vertex position of each output triangle's polygon's first vertex,
    used to fetch the GetPolygonVertexNormal(poly, 0) normal."""
    faces = []
    first_pv = []
    start = 0
    poly_id = []
    n_poly = 0
    for i, v in enumerate(pvi):
        if v < 0:
            poly = list(pvi[start:i]) + [~int(v)]
            for k in range(1, len(poly) - 1):
                faces.append((poly[0], poly[k], poly[k + 1]))
                first_pv.append(start)
                poly_id.append(n_poly)
            n_poly += 1
            start = i + 1
    return (np.asarray(faces, np.int32),
            np.asarray(first_pv, np.int32),
            np.asarray(poly_id, np.int32))


def _face_normals(geom: FbxNode, first_pv: np.ndarray, faces: np.ndarray,
                  points: np.ndarray,
                  poly_id: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-triangle normal a la GetPolygonVertexNormal(polyIndex, 0)
    (FbxLoader.h:58-61): the loaded normal at the polygon's first vertex."""
    ln = geom.find("LayerElementNormal")
    if ln is None:
        e1 = points[faces[:, 1]] - points[faces[:, 0]]
        e2 = points[faces[:, 2]] - points[faces[:, 0]]
        n = np.cross(e1, e2)
        return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
                ).astype(np.float32)
    normals = np.asarray(ln.find("Normals").props[0], np.float64).reshape(-1, 3)
    mapping = ln.find("MappingInformationType").props[0]
    ref = ln.find("ReferenceInformationType").props[0]
    nidx_node = ln.find("NormalsIndex")
    if mapping == "ByPolygonVertex":
        sel = first_pv
    elif mapping == "ByControlPoint":
        sel = faces[:, 0]
    else:  # ByPolygon: one normal per SOURCE polygon, not per triangle —
        # fan-triangulated quads/n-gons map every triangle back to its
        # polygon's row (arange(len(faces)) would read past the table)
        sel = (poly_id if poly_id is not None
               else np.arange(len(faces)))
    if ref == "IndexToDirect" and nidx_node is not None:
        nidx = np.asarray(nidx_node.props[0], np.int64)
        sel = nidx[sel]
    return normals[sel].astype(np.float32)


def load_skinned_mesh(path: str, fps: int = 60,
                      max_frames: Optional[int] = None) -> SkinnedMesh:
    """CreateFBXData parity (FbxLoader.h:185-214)."""
    scene = FbxScene(path)

    # --- mesh (GetMeshData, :11-65) ---
    geom = None
    geom_id = None
    n_geoms = 0
    for uid, n in scene.by_id.items():
        if n.name == "Geometry":
            n_geoms += 1
            if geom is None:
                geom, geom_id = n, uid
    if geom is None:
        raise ValueError(f"{path}: no Geometry")
    if n_geoms > 1:
        # the reference also takes the first mesh (FbxLoader.h:189-192
        # GetChild(0) recursion stops at the first eMesh)
        import warnings
        warnings.warn(f"{path}: {n_geoms} meshes found; loading the first "
                      "only (reference behavior, FbxLoader.h:189-192)")
    points = np.asarray(geom.find("Vertices").props[0], np.float64).reshape(-1, 3)
    pvi = np.asarray(geom.find("PolygonVertexIndex").props[0], np.int64)
    faces, first_pv, poly_id = _triangulate(pvi)
    normals = _face_normals(geom, first_pv, faces, points, poly_id)

    # --- skin clusters (GetBoneData, :67-103) ---
    parent_map: Dict[int, List[int]] = {}
    for child, parent in scene.oo:
        parent_map.setdefault(parent, []).append(child)

    skins = [uid for uid in parent_map.get(geom_id, [])
             if scene.by_id.get(uid) is not None
             and scene.by_id[uid].name == "Deformer"
             and scene.by_id[uid].props[2] == "Skin"]
    clusters: List[Tuple[FbxNode, FbxModel]] = []
    if skins:
        for cuid in parent_map.get(skins[0], []):
            cn = scene.by_id.get(cuid)
            if cn is None or cn.name != "Deformer" or cn.props[2] != "Cluster":
                continue
            link = None
            for child, parent in scene.oo:
                if parent == cuid and child in scene.models:
                    link = scene.models[child]
                    break
            if link is not None:
                clusters.append((cn, link))

    n_points = points.shape[0]
    n_bones = len(clusters)
    weights = np.zeros((n_points, max(n_bones, 1)), np.float64)
    bone_names: List[str] = []
    bone_default_t = np.zeros((max(n_bones, 1), 3), np.float64)
    bone_default_r = np.zeros((max(n_bones, 1), 3), np.float64)
    transform_mats = np.tile(np.eye(4), (max(n_bones, 1), 1, 1))
    transform_links = np.tile(np.eye(4), (max(n_bones, 1), 1, 1))

    for bi, (cn, link) in enumerate(clusters):
        bone_names.append(link.name)
        idx_node = cn.find("Indexes")
        w_node = cn.find("Weights")
        if idx_node is not None and w_node is not None:
            idx = np.asarray(idx_node.props[0], np.int64)
            w = np.asarray(w_node.props[0], np.float64)
            weights[idx, bi] = w
        # stored matrices are the transpose of column-convention
        tr = cn.find("Transform")
        tl = cn.find("TransformLink")
        if tr is not None:
            transform_mats[bi] = np.asarray(tr.props[0], np.float64).reshape(4, 4).T
        if tl is not None:
            transform_links[bi] = np.asarray(tl.props[0], np.float64).reshape(4, 4).T
        g = scene.global_transform(link, None)  # bind defaults (:85-89)
        t, r = matrix_to_trs(g)
        bone_default_t[bi] = t
        bone_default_r[bi] = r

    # --- animation (GetAnimationData, :105-183) ---
    start, stop = scene.take_span()
    one_frame = KTIME_PER_SECOND // fps
    frame_count = max(int((stop - start) // one_frame), 1)
    if max_frames is not None:
        frame_count = min(frame_count, max_frames)

    # identity (not zeros): a no-cluster mesh must skin to its bind pose
    vertex_transforms = np.tile(np.eye(4),
                                (frame_count, max(n_bones, 1), 1, 1))
    bone_now_t = np.zeros((frame_count, max(n_bones, 1), 3), np.float64)
    bone_now_r = np.zeros((frame_count, max(n_bones, 1), 3), np.float64)

    for f in range(frame_count):
        ktime = f * one_frame  # frameIndex * oneFrameValue (:141, start unused)
        global_pos = np.eye(4)  # scene root global (identity, :139-145)
        inv_global = np.linalg.inv(global_pos)
        for bi, (cn, link) in enumerate(clusters):
            # GetTransformMatrix (:151-152) returns the MESH's bind global;
            # the file stores cluster 'Transform' = TL^-1 @ mesh_bind, so the
            # SDK value is TL @ stored (verified: constant across clusters,
            # equal to the mesh model's bind transform).
            ref_init = transform_links[bi] @ transform_mats[bi]
            cluster_init = transform_links[bi]     # GetTransformLinkMatrix (:153)
            current = scene.global_transform(link, ktime)   # (:154)
            vt = (inv_global @ current) @ (np.linalg.inv(cluster_init) @ ref_init)
            vertex_transforms[f, bi] = vt
            t, r = matrix_to_trs(current)          # (:175-178)
            bone_now_t[f, bi] = t
            bone_now_r[f, bi] = r

    return SkinnedMesh(
        points=points.astype(np.float32),
        faces=faces,
        normals=normals,
        bone_names=bone_names,
        weights=weights.astype(np.float32),
        bone_default_t=bone_default_t.astype(np.float32),
        bone_default_r=bone_default_r.astype(np.float32),
        frame_count=frame_count,
        vertex_transforms=vertex_transforms.astype(np.float32),
        bone_now_t=bone_now_t.astype(np.float32),
        bone_now_r=bone_now_r.astype(np.float32),
    )
