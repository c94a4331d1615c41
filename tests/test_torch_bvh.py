"""The port's BVH against the JAX package on the CPU: the host build (numpy
and the native C++ builder), the refit, the traversal's plain version
(the yardstick of the crt_bvh_traverse kernel), the bone forest,
``intersect_scene_bvh`` and a path render through ``bvh_intersector``.

Inputs come from a seed through numpy (the meshes and rays of
tests/test_bvh.py and tests/test_bone_bvh.py) and go to both packages; the
render's scatter stream is JAX's ``stream_from_key``, injected into both.

Tolerances:
  * build and refit: equal, field for field (the same float32 min, max and
    pad on both sides);
  * traversal: the ids equal except on rays whose winner JAX's FMA
    contraction flips (XLA contracts a * b + c on the CPU; the port rounds
    each product and sum, as the kernel does), at most 1 in 256 rays; t to
    1e-5 relative;
  * hit records: idx and hit mask equal, t to 1e-5 relative, p and the
    normal to 1e-4;
  * radiance: atol 2e-4, rtol 1e-4 on every ray, the band of the port's
    other wavefront tests (tests/test_torch_wavefront.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import Quirks as JQuirks
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core.rays import make_rays
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.ops import bone_bvh as jbb
from cudaraytracer_tpu.ops import bvh as jbvh
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import intersect as jisect
from cudaraytracer_tpu.ops import render as jrender
from cudaraytracer_tpu_torch import native as tnative
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.ops import bone_bvh as tbb
from cudaraytracer_tpu_torch.ops import bvh as tbvh
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import intersect as tisect
from cudaraytracer_tpu_torch.ops import render as trender
from cudaraytracer_tpu_torch.ops import sweeps as tsw
from cudaraytracer_tpu_torch.utils.convert import (flat_bvh_from_numpy,
                                                   scene_from_numpy)
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_sample_injection import _grid_rays, _stochastic_scene

BIG = tsw.BIG          # float32's largest finite value
FIELDS = ("bbox_min", "bbox_max", "is_leaf", "skip", "prim0", "prim1",
          "child_l", "child_r")
PROFILES = {"reference": JQuirks.reference(), "fixed": JQuirks.fixed()}


def _random_mesh(rng, n_tri=60, spread=4.0, z_off=-8.0):
    """tests/test_bvh.py's mesh: (v0, v1, v2, unit normal) float32[T, 3]."""
    c = rng.uniform(-spread, spread, size=(n_tri, 3)) + np.array(
        [0, 0, z_off])
    a = c + rng.normal(scale=0.4, size=(n_tri, 3))
    b = c + rng.normal(scale=0.4, size=(n_tri, 3))
    d = c + rng.normal(scale=0.4, size=(n_tri, 3))
    n = np.cross(b - a, d - a)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return tuple(x.astype(np.float32) for x in (a, b, d, n))


def _random_rays(rng, n=128):
    """tests/test_bvh.py's rays: (origin, direction) float32[N, 3]."""
    o = rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    return o, d


def _aimed_rays(rng, n, v0, v1, v2):
    """Rays from near the origin at random points of random triangles (of
    the rays above, a tenth hit anything)."""
    o = rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    k = rng.integers(0, len(v0), n)
    w = rng.dirichlet([1.0, 1.0, 1.0], n)
    target = w[:, :1] * v0[k] + w[:, 1:2] * v1[k] + w[:, 2:] * v2[k]
    return o, (target - o).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _tq(q):
    return Quirks(**q.__dict__)


def _rays(o, d):
    o, d = _t(o, d)
    return Rays(o, d, torch.zeros(o.shape[0]))


def _assert_same_layout(got, ref):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    assert len(got.levels) == len(ref.levels)
    for a, b in zip(got.levels, ref.levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _assert_walks_match(got, ref, max_flips):
    """traverse (t, prim) against JAX's: ids equal but for at most
    max_flips rays, t to 1e-5 relative where both hit the same prim ->
    the flips."""
    gt, gp = (x.numpy() for x in got)
    rt, rp = (np.asarray(x) for x in ref)
    flips = int((gp != rp).sum())
    assert flips <= max_flips, flips
    same = (gp == rp) & (rp >= 0)
    np.testing.assert_allclose(gt[same], rt[same], rtol=1e-5)
    assert np.all(gt[gp < 0] == BIG)
    assert same.any()
    return flips


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis_mode", ["largest", "random"])
@pytest.mark.parametrize("backend", ["python", "native"])
def test_build_matches_jax(axis_mode, backend):
    """Both builders against JAX's, field for field: the Python builders
    on numpy's generator; under 'random' the native builders on mt19937
    each (the two generators draw different axes)."""
    rng = np.random.default_rng(0)
    v0, v1, v2, _ = _random_mesh(rng, 157)
    ref_backend = "native" if (backend == "native"
                               and axis_mode == "random") else "python"
    ref = jbvh.build_triangle_bvh(v0, v1, v2, axis_mode=axis_mode, seed=7,
                                  backend=ref_backend)
    got = tbvh.build_triangle_bvh(v0, v1, v2, axis_mode=axis_mode, seed=7,
                                  backend=backend, device="cpu")
    _assert_same_layout(got, ref)
    assert got.n_nodes == ref.n_nodes
    if backend == "native":
        # built into the port's own build directory, not beside the source
        lib = tnative.library_path()
        assert lib.exists() and lib.parent.name == "_build"
        assert lib.parent.parent.name == "cudaraytracer_tpu_torch"


def test_build_edge_cases_match_jax():
    """One triangle (a lone leaf), one-prim leaves, prims with equal
    bounds (the stable sort's order), and the wide-leaf error."""
    rng = np.random.default_rng(1)
    lo = rng.uniform(-1, 0, (24, 3)).astype(np.float32)
    lo[8:16] = lo[8]                       # ties along every axis
    hi = lo + rng.uniform(0.1, 0.5, (24, 3)).astype(np.float32)
    for n, leaf in ((1, 2), (24, 1), (24, 2)):
        ref = jbvh.build_bvh(lo[:n], hi[:n], leaf_size=leaf,
                             backend="python")
        for backend in ("python", "native"):
            _assert_same_layout(tbvh.build_bvh(
                lo[:n], hi[:n], leaf_size=leaf, backend=backend,
                device="cpu"), ref)
    with pytest.raises(ValueError, match="leaf_size"):
        tbvh.build_bvh(lo, hi, leaf_size=4, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tbvh.build_bvh(lo, hi, backend="cuda", device="cpu")


# ---------------------------------------------------------------------------
# Refit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("motion", ["translate", "deform"])
def test_refit_matches_jax(motion):
    rng = np.random.default_rng(2)
    v0, v1, v2, _ = _random_mesh(rng, 80)
    ref_bvh = jbvh.build_triangle_bvh(v0, v1, v2)
    bvh = flat_bvh_from_numpy(_np(ref_bvh), "cpu")
    if motion == "translate":
        delta = np.array([10.0, -3.0, 5.0], np.float32)
        w = [v + delta for v in (v0, v1, v2)]
    else:
        w = [v + rng.normal(scale=0.5, size=v.shape).astype(np.float32)
             for v in (v0, v1, v2)]
    ref = jbvh.refit_bvh(ref_bvh, *map(jnp.asarray, w))
    got = tbvh.refit_bvh(bvh, *_t(*w))
    _assert_same_layout(got, ref)
    assert got.prim1 is bvh.prim1          # the topology is shared


# ---------------------------------------------------------------------------
# Traversal (the kernel's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shrink", [False, True])
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_traversal_plain_matches_jax(profile, shrink):
    """traverse_bvh_plain on JAX's own tree against JAX's traverse_bvh, on
    the mesh before and after a deforming refit."""
    quirks = PROFILES[profile]
    rng = np.random.default_rng(3)
    v0, v1, v2, nrm = _random_mesh(rng, 120)
    o, d = _random_rays(rng, 512)
    jtree = jbvh.build_triangle_bvh(v0, v1, v2)
    w = [v + rng.normal(scale=0.3, size=v.shape).astype(np.float32)
         for v in (v0, v1, v2)]
    jrays = make_rays(jnp.asarray(o), jnp.asarray(d))
    for verts, tree in (((v0, v1, v2), jtree),
                        (w, jbvh.refit_bvh(jtree, *map(jnp.asarray, w)))):
        ref = jbvh.traverse_bvh(tree, *map(jnp.asarray, (*verts, nrm)),
                                jrays, 1e-3, BIG, quirks, shrink=shrink)
        got = tbvh.traverse_bvh(flat_bvh_from_numpy(_np(tree), "cpu"),
                                *_t(*verts, nrm), _rays(o, d), 1e-3, BIG,
                                _tq(quirks), shrink=shrink)
        _assert_walks_match(got, ref, max_flips=2)


def test_traversal_plain_dead_lanes_and_brute_force():
    """A dead lane is a miss and every live lane keeps its winner; with
    shrink the walk equals the port's brute force (its winner is the first
    prim of the least t, which the walk finds on these rays)."""
    rng = np.random.default_rng(4)
    v0, v1, v2, nrm = _random_mesh(rng, 100)
    o, d = _aimed_rays(rng, 300, v0, v1, v2)
    bvh = tbvh.build_triangle_bvh(v0, v1, v2, device="cpu")
    tv = _t(v0, v1, v2, nrm)
    rays = _rays(o, d)
    alive = torch.from_numpy(rng.uniform(size=300) < 0.6)
    for quirks in (Quirks.reference(), Quirks.fixed()):
        full = tbvh.traverse_bvh(bvh, *tv, rays, 1e-3, BIG, quirks)
        dead = tbvh.traverse_bvh(bvh, *tv, rays, 1e-3, BIG, quirks,
                                 alive=alive)
        assert torch.equal(dead[1], torch.where(alive, full[1], -1))
        assert torch.equal(dead[0], torch.where(alive, full[0], BIG))
        walk = tbvh.traverse_bvh(bvh, *tv, rays, 1e-3, BIG, quirks,
                                 shrink=True)
        brute = tisect.intersect_scene(_mesh_scene(v0, v1, v2, nrm), rays,
                                       quirks=quirks)
        if not quirks.triangle_no_t_clip:
            # (under the quirk the brute force also takes hits behind the
            # origin, which no box reaches: t_min cuts the slab)
            assert torch.equal(walk[1], brute.prim)
        same = (walk[1] >= 0) & (walk[1] == brute.prim)
        assert same.sum() >= 20
        # the brute force's dot products sum in another order
        torch.testing.assert_close(walk[0][same], brute.t[same], rtol=1e-4,
                                   atol=0)


def _mesh_scene(v0, v1, v2, nrm):
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    b = SceneBuilder()
    mat = b.materials.lambertian(color=(0.7, 0.2, 0.2))
    pts = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)
    b.add_mesh(pts, np.arange(len(pts)).reshape(-1, 3), mat, normals=nrm,
               reverse_winding=False)
    return b.build("cpu")


def test_traversal_plain_axis_parallel_rays_on_box_planes():
    """Axis-parallel rays whose origins lie on node planes: (lo - o) * inf
    is NaN there, and NaN misses the node in both packages."""
    rng = np.random.default_rng(5)
    v0, v1, v2, nrm = _random_mesh(rng, 64)
    jtree = jbvh.build_triangle_bvh(v0, v1, v2)
    box = np.concatenate([np.asarray(jtree.bbox_min),
                          np.asarray(jtree.bbox_max),
                          np.zeros((jtree.n_nodes, 2), np.float32)], 1)
    o, d = cs.plane_rays(box, v0.mean(0), 512, 5)
    jrays = make_rays(jnp.asarray(o), jnp.asarray(d))
    for quirks in PROFILES.values():
        ref = jbvh.traverse_bvh(jtree, *map(jnp.asarray, (v0, v1, v2, nrm)),
                                jrays, 1e-3, BIG, quirks)
        got = tbvh.traverse_bvh(flat_bvh_from_numpy(_np(jtree), "cpu"),
                                *_t(v0, v1, v2, nrm), _rays(o, d), 1e-3,
                                BIG, _tq(quirks))
        _assert_walks_match(got, ref, max_flips=2)


def test_bvh_best_hit_gradients_match_the_triangle_sweep():
    """bvh_best_hit's t carries the triangle sweep's gradients (K4's
    winner-only backward, held against finite differences in
    tests/test_torch_wavefront.py) to the vertices and to the rays."""
    rng = np.random.default_rng(6)
    v0, v1, v2, nrm = _random_mesh(rng, 50)
    o, d = _aimed_rays(rng, 200, v0, v1, v2)
    bvh = tbvh.build_triangle_bvh(v0, v1, v2, device="cpu")
    q = Quirks.fixed()
    grads = []
    for use_bvh in (True, False):
        leaves = [x.clone().requires_grad_() for x in _t(v0, v1, v2, o, d)]
        tv0, tv1, tv2, to, td = leaves
        n = _t(nrm)[0]
        if use_bvh:
            t, idx = tbvh.bvh_best_hit(bvh, tv0, tv1, tv2, n,
                                       Rays(to, td, torch.zeros(200)), 1e-3,
                                       BIG, q)
        else:
            t, idx = tsw.triangle_best_hit(to, td, tv0, tv1, tv2, n, 1e-3,
                                           BIG, q)
        hit = idx >= 0
        assert hit.sum() >= 100
        torch.where(hit, t, 0.0).sum().backward()
        grads.append([x.grad for x in leaves])
    for g_bvh, g_sweep in zip(*grads):
        assert g_bvh.abs().max() > 0
        torch.testing.assert_close(g_bvh, g_sweep, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Bone forest
# ---------------------------------------------------------------------------

def test_partition_rule_matches_jax():
    """createScene.h:262-288 on tests/test_bone_bvh.py's cases (a triangle
    split over two bones is an orphan; a triangle in both bones' sets goes
    to the lower bone) and on the skinned stand-ins."""
    cases = [(np.array([[1.0, 0.0], [0.7, 0.3], [1.0, 0.0], [0.0, 1.0]]),
              np.array([[0, 1, 2], [1, 2, 3]])),
             (np.array([[0.5, 0.5], [0.5, 0.5], [0.5, 0.5]]),
              np.array([[0, 1, 2]]))]
    for mesh in (cs.skinned_capsule(), cs.skinned_field()):
        cases.append((mesh.weights, mesh.faces))
    for weights, faces in cases:
        np.testing.assert_array_equal(tbb.partition_by_bone(weights, faces),
                                      jbb.partition_by_bone(weights, faces))
    assert tbb.partition_by_bone(*cases[0]).tolist() == [0, -1]
    assert tbb.partition_by_bone(*cases[1]).tolist() == [0]


def _forest_mesh(rng):
    """A random mesh of 90 triangles on three bones: each triangle's
    vertices weighted to its bone, every tenth triangle blended over two
    bones (an orphan)."""
    v0, v1, v2, nrm = _random_mesh(rng, 90)
    faces = np.arange(270).reshape(90, 3)
    weights = np.zeros((270, 3), np.float32)
    bone = rng.integers(0, 3, 90)
    for k in range(90):
        weights[faces[k], bone[k]] = 1.0
        if k % 10 == 0:
            weights[faces[k][0], (bone[k] + 1) % 3] = 0.5
            weights[faces[k][0], bone[k]] = 0.0
    return v0, v1, v2, nrm, weights, faces


@pytest.mark.parametrize("orphans", ["drop", "keep"])
def test_forest_matches_jax(orphans):
    """The forest's layout, its traversal and its refit against JAX's."""
    rng = np.random.default_rng(7)
    v0, v1, v2, nrm, weights, faces = _forest_mesh(rng)
    ref = jbb.build_bone_forest(v0, v1, v2, weights, faces, orphans=orphans)
    got = tbb.build_bone_forest(v0, v1, v2, weights, faces, orphans=orphans,
                                device="cpu")
    _assert_same_layout(got.bvh, ref.bvh)
    np.testing.assert_array_equal(got.bone_of_tri, ref.bone_of_tri)
    np.testing.assert_array_equal(got.root_offsets, ref.root_offsets)
    np.testing.assert_array_equal(got.root_bones, ref.root_bones)
    assert got.n_dropped == ref.n_dropped == (
        9 if orphans == "drop" else 0)
    o, d = _random_rays(rng, 256)
    jrays = make_rays(jnp.asarray(o), jnp.asarray(d))
    w = [v + rng.normal(scale=0.3, size=v.shape).astype(np.float32)
         for v in (v0, v1, v2)]
    ref_fit = jbvh.refit_bvh(ref.bvh, *map(jnp.asarray, w))
    got_fit = tbvh.refit_bvh(got.bvh, *_t(*w))
    _assert_same_layout(got_fit, ref_fit)
    for quirks in PROFILES.values():
        for verts, jtree, ttree in (((v0, v1, v2), ref.bvh, got.bvh),
                                    (w, ref_fit, got_fit)):
            r = jbvh.traverse_bvh(jtree, *map(jnp.asarray, (*verts, nrm)),
                                  jrays, 1e-3, BIG, quirks)
            g = tbvh.traverse_bvh(ttree, *_t(*verts, nrm), _rays(o, d),
                                  1e-3, BIG, _tq(quirks))
            _assert_walks_match(g, r, max_flips=1)


def test_empty_forest_raises_as_jax():
    """No triangle inside one bone's weight set and orphans dropped: both
    packages refuse loudly (an unskinned mesh's all-zero weights too)."""
    rng = np.random.default_rng(8)
    v0, v1, v2, _ = _random_mesh(rng, 6)
    faces = np.arange(18).reshape(6, 3)
    for weights in (np.zeros((18, 1), np.float32),
                    np.tile(np.eye(3, dtype=np.float32), (6, 1))):
        with pytest.raises(ValueError, match="empty bone forest"):
            jbb.build_bone_forest(v0, v1, v2, weights, faces)
        with pytest.raises(ValueError, match="empty bone forest"):
            tbb.build_bone_forest(v0, v1, v2, weights, faces, device="cpu")


# ---------------------------------------------------------------------------
# Scene and slice
# ---------------------------------------------------------------------------

def _jax_mixed_scene(rng):
    """tests/test_bvh.py's scene: a random mesh, a metal sphere and a
    rect."""
    b = JSceneBuilder()
    m = b.materials
    mat = m.lambertian(color=(0.7, 0.2, 0.2))
    v0, v1, v2, nrm = _random_mesh(rng, 40)
    pts = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)
    b.add_mesh(pts, np.arange(120).reshape(40, 3), mat, normals=nrm,
               reverse_winding=False)
    b.add_sphere((0, 0, -5), 0.8, m.metal((0.9, 0.9, 0.9), 0.0))
    b.add_rect(mat, flip=False, position=(0, 0, -12))
    return b.build()


@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_intersect_scene_bvh_matches_jax(profile):
    quirks = PROFILES[profile]
    rng = np.random.default_rng(9)
    js = _jax_mixed_scene(rng)
    tr = js.triangles
    jtree = jbvh.build_triangle_bvh(np.asarray(tr.v0), np.asarray(tr.v1),
                                    np.asarray(tr.v2))
    o, d = _aimed_rays(rng, 400, *(np.asarray(x) for x in (
        tr.v0, tr.v1, tr.v2)))
    ref = jisect.intersect_scene_bvh(
        js, make_rays(jnp.asarray(o), jnp.asarray(d)), jtree, quirks=quirks)
    ts = scene_from_numpy(_np(js), "cpu")
    got = tisect.intersect_scene_bvh(ts, _rays(o, d),
                                     flat_bvh_from_numpy(_np(jtree), "cpu"),
                                     quirks=_tq(quirks))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    assert len(set(got.prim[got.hit].tolist())) >= 5
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    for k in ("p", "normal"):
        np.testing.assert_allclose(getattr(got, k).numpy()[hit],
                                   np.asarray(getattr(ref, k))[hit],
                                   atol=1e-4)
    # a dead lane is a miss, a live one keeps its record
    alive = torch.from_numpy(rng.uniform(size=400) < 0.5)
    part = tisect.intersect_scene_bvh(ts, _rays(o, d),
                                      flat_bvh_from_numpy(_np(jtree), "cpu"),
                                      quirks=_tq(quirks), alive=alive)
    assert torch.equal(part.prim, torch.where(alive, got.prim, -1))


def test_path_render_through_bvh_matches_jax():
    """A 32x16x2 path render (1,024 rays, depth 8) through bvh_intersector
    against JAX's trace_path with its bvh_intersector, one injected
    stream; the stochastic scene of tests/test_sample_injection.py (the
    forward t window, as that test sets it)."""
    js = _stochastic_scene()
    jcfg = JConfig(width=32, height=16, samples=2, max_depth=8,
                   integrator="path",
                   quirks=JQuirks(triangle_no_t_clip=False))
    jrays = _grid_rays(32, 32)
    n = jrays.origin.shape[0]
    stream = jinteg.stream_from_key(jax.random.key(11), n, jcfg.max_depth)
    tr = js.triangles
    jtree = jbvh.build_triangle_bvh(np.asarray(tr.v0), np.asarray(tr.v1),
                                    np.asarray(tr.v2))
    ref = np.asarray(jinteg.trace_path(
        js, jrays, jax.random.key(11), jcfg,
        intersect_fn=jrender.bvh_intersector(jcfg), aux=jtree,
        samples=stream))
    ts = scene_from_numpy(_np(js), "cpu")
    tcfg = RenderConfig(width=32, height=16, samples=2, max_depth=8,
                        integrator="path", quirks=_tq(jcfg.quirks))
    tree = tbvh.build_triangle_bvh(ts.triangles.v0, ts.triangles.v1,
                                   ts.triangles.v2, device="cpu")
    got = tinteg.trace_path(
        ts, Rays(*_t(*map(np.asarray, jrays))), tcfg,
        intersect_fn=trender.bvh_intersector(tcfg, tree),
        samples=tinteg.SampleStream(*_t(np.asarray(stream.ball),
                                        np.asarray(stream.prob))))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-4)
    brute = tinteg.trace_path(
        ts, Rays(*_t(*map(np.asarray, jrays))), tcfg,
        samples=tinteg.SampleStream(*_t(np.asarray(stream.ball),
                                        np.asarray(stream.prob))))
    np.testing.assert_allclose(got.numpy(), brute.numpy(), atol=1e-5)
    assert float(got.mean()) > 0.05


def test_render_cli_accel_bvh(tmp_path, capsys):
    """apps/render.py --accel bvh renders on the wavefront through the BVH
    as the brute force does; on a scene without triangles it labels itself
    bvh->bruteforce."""
    from cudaraytracer_tpu_torch.apps import render as app
    from cudaraytracer_tpu_torch.utils.image import read_png
    args = ["--cpu", "--width", "24", "--height", "16", "--spp", "1",
            "--max-depth", "2", "--quirks", "fixed"]
    for accel in ("bvh", "bruteforce"):
        assert app.main([*args, "--scene", "icosphere", "--accel", accel,
                         "--out", str(tmp_path / f"{accel}.png")]) == 0
    assert "(path, bvh on cpu)" in capsys.readouterr().out
    np.testing.assert_array_equal(read_png(str(tmp_path / "bvh.png")),
                                  read_png(str(tmp_path / "bruteforce.png")))
    assert app.main([*args, "--accel", "bvh", "--out",
                     str(tmp_path / "spheres.png")]) == 0
    assert "bvh->bruteforce" in capsys.readouterr().out


def test_traverse_bvh_refuses_other_devices():
    rng = np.random.default_rng(10)
    v0, v1, v2, nrm = _random_mesh(rng, 8)
    bvh = tbvh.build_triangle_bvh(v0, v1, v2, device="cpu")
    o, d = _random_rays(rng, 4)
    rays = Rays(*_t(o, d), torch.zeros(4))
    meta = Rays(*(x.to("meta") for x in rays))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tbvh.traverse_bvh(bvh, *_t(v0, v1, v2, nrm), meta, 1e-3, BIG,
                          Quirks.fixed())
