"""The port's scene side (SceneBuilder, presets, textures, conversion, the
fused kernel's tables) against the JAX package.

Everything here is data movement or host numpy math that both packages do
with the same float32 operations, so it is held EXACT, apart from the two
cameras (atol 1e-6: torch and XLA round the basis normalisation apart by an
ulp).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.models import presets as jpresets
from cudaraytracer_tpu.models import textures as jtex
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.ops import megakernel as jmk
from cudaraytracer_tpu_torch.config import RenderConfig
from cudaraytracer_tpu_torch.core.camera import make_camera
from cudaraytracer_tpu_torch.core.rays import make_rays
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.models import textures as ttex
from cudaraytracer_tpu_torch.models.scene import SceneBuilder
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.ops import sweeps as tsw
from cudaraytracer_tpu_torch.ops.integrators import SampleStream
from cudaraytracer_tpu_torch.ops.render import render_image
from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                   scene_from_numpy, to_numpy)
from test_megakernel import _mixed_scene
from test_torch_megakernel import _stream_np


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _assert_records_equal(got, ref, path="scene"):
    """Field-by-field exact equality of two records of arrays."""
    if hasattr(ref, "_fields"):
        for name in ref._fields:
            _assert_records_equal(getattr(got, name), getattr(ref, name),
                                  f"{path}.{name}")
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == ref.dtype, (path, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=path)


@pytest.mark.parametrize("name", ["three_spheres", "random_spheres"])
def test_presets_match_jax(name):
    js, jc = getattr(jpresets, name)(aspect=2.0)
    ts, tc = getattr(tpresets, name)(aspect=2.0, device="cpu")
    _assert_records_equal(ts, _np_tree(js))
    for a, b in zip(tc, _np_tree(jc)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    if name == "random_spheres":
        assert ts.n_spheres == 484


def test_fbx_walk_camera_matches_jax():
    ref = _np_tree(jpresets.fbx_walk_camera(2.0))
    got = tpresets.fbx_walk_camera(2.0, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("name", ["light_box", "textured_globe"])
def test_slice5_presets_raise(name):
    """light_box (a rect, kernel mode K8) and textured_globe (image
    textures on a sphere and a rect light, kernel modes K8 and K9) build
    the JAX presets' scenes and cameras, and the fused engine takes both;
    neither raises any more."""
    js, jc = getattr(jpresets, name)(aspect=2.0)
    ts, tc = getattr(tpresets, name)(aspect=2.0, device="cpu")
    _assert_records_equal(ts, _np_tree(js))
    for a, b in zip(tc, _np_tree(jc)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-6)
    assert ts.n_rects == 1 and tmk.megakernel_supported(ts)


def test_convert_round_trip_is_exact():
    js, jc = _mixed_scene()
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    _assert_records_equal(to_numpy(ts), tree)
    _assert_records_equal(to_numpy(camera_from_numpy(_np_tree(jc), "cpu")),
                          _np_tree(jc))
    assert (ts.n_spheres, ts.n_triangles, ts.n_rects) == \
        (js.n_spheres, js.n_triangles, js.n_rects)


def _mesh(seed, n_pts=40, n_faces=60):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    faces = rng.integers(0, n_pts, (n_faces, 3)).astype(np.int32)
    return pts, faces


def _both_builders(fill):
    jb, tb = JSceneBuilder(), SceneBuilder()
    fill(jb)
    fill(tb)
    return jb.build(), tb.build("cpu")


def test_scene_builder_mesh_rects_and_trs_match_jax():
    pts, faces = _mesh(1)

    def fill(b):
        m = b.materials
        red = m.lambertian(color=(0.8, 0.1, 0.1))
        b.add_mesh(pts, faces, red, position=(0.5, 0, -2),
                   rotation=(0, 30, 0), scale=(2, 2, 2))
        b.add_mesh(pts, faces[:5], m.metal((0.5, 0.5, 0.5), 0.3),
                   reverse_winding=False)
        b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), red)
        b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), red,
                       rotation=(10, 0, 0))
        b.add_sphere((0, 1, 0), 0.5, m.dielectric(1.3), scale=(1, 2, 1))
        b.add_rect(m.diffuse_light(color=(3, 3, 3)), flip=True,
                   position=(0, 2, 0), scale=(2, 2, 1))
        b.add_sphere((1, 1, 1), 0.25, m.lambertian(
            tex_id=m.textures.checker((0, 0, 0), (1, 1, 1))))

    js, ts = _both_builders(fill)
    _assert_records_equal(ts, _np_tree(js))
    assert (ts.n_triangles, ts.n_t_triangles, ts.n_t_spheres, ts.n_rects) \
        == (66, 1, 1, 1)
    # rects and runtime-TRS prims are built, and the engine (K8) takes them
    assert tmk.megakernel_supported(ts)
    tt = tmk.build_mega_tables(ts)
    assert (tt.rect.shape[0], tt.tsph.shape[0], tt.ttri.shape[0]) == (1, 1, 1)


def test_with_triangle_vertices_keeps_normals():
    pts, faces = _mesh(2)

    def fill(b):
        b.add_mesh(pts, faces, b.materials.lambertian(color=(1, 1, 1)))

    js, ts = _both_builders(fill)
    v = np.random.default_rng(3).standard_normal((3, 60, 3)).astype(
        np.float32)
    jn = js.with_triangle_vertices(*v)
    tn = ts.with_triangle_vertices(*(torch.from_numpy(x) for x in v))
    _assert_records_equal(tn, _np_tree(jn))
    assert torch.equal(tn.triangles.normal, ts.triangles.normal)


def test_eval_texture_matches_jax():
    def fill(tb):
        tb.constant((0.1, 0.2, 0.3))
        tb.checker((0.9, 0.8, 0.7), (0.0, 0.1, 0.2))
        tb.checker((1, 1, 1), (0, 0, 0))

    jb, tb = jtex.TextureBuilder(), ttex.TextureBuilder()
    fill(jb)
    fill(tb)
    jt, tt = jb.build(), tb.build("cpu")
    rng = np.random.default_rng(4)
    tid = rng.integers(0, 3, 256).astype(np.int32)
    p = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    zero = np.zeros(256, np.float32)
    ref = np.asarray(jtex.eval_texture(jt, tid, zero, zero, p))
    got = ttex.eval_texture(tt, torch.from_numpy(tid), torch.from_numpy(zero),
                            torch.from_numpy(zero), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_morton_orders_match_jax():
    from cudaraytracer_tpu.ops.pallas_intersect import morton_order
    pts, faces = _mesh(5, 200, 300)
    v0, v1, v2 = (pts[faces[:, k]] for k in range(3))
    np.testing.assert_array_equal(tmk.morton_order(v0, v1, v2),
                                  morton_order(v0, v1, v2))
    np.testing.assert_array_equal(tmk.mega_sphere_order(v0),
                                  jmk.mega_sphere_order(v0))


def _widened(jax_box, k, margin):
    """JAX's exact boxes (its first k rows) widened as the port widens its
    own (ops/megakernel.py ``_levels``: margin x each box's largest
    |coordinate|)."""
    box = torch.zeros(k, 8)
    box[:, :6] = torch.tensor(np.asarray(jax_box[:k, :6]))
    return tsw.widen_boxes(box, margin).numpy()[:, :6]


def _assert_tables_match(js, ts, tri_order, sph_order):
    """The port's tables hold the JAX tables' columns and rows exactly, and
    a row's scene id in a pad column (K7's id, the row map's value); its
    chunk and super boxes are JAX's exact boxes widened by the port's
    margins (SPH_MARGIN, TRI_MARGIN); the TPU padding (128 lanes, box rows
    to a multiple of 8) is gone."""
    jt = _np_tree(jmk.build_mega_tables(js, tri_order=tri_order,
                                        sph_order=sph_order))
    tt = to_numpy(tmk.build_mega_tables(ts, tri_order, sph_order))
    if js.n_spheres:
        np.testing.assert_array_equal(tt.sph[:, :14], jt.sph[:, :14])
        assert not tt.sph[:, 14].any()
        np.testing.assert_array_equal(tt.sph[:, tmk.S_ID], tt.sph_map)
        k = tt.sph_box.shape[0]
        np.testing.assert_array_equal(
            tt.sph_box[:, :6], _widened(jt.sph_box, k, tsw.SPH_MARGIN))
        if js.n_spheres > tmk.SPH_SUPER_MIN:
            k = tt.sph_super.shape[0]
            np.testing.assert_array_equal(
                tt.sph_super[:, :6],
                _widened(jt.sph_super, k, tsw.SPH_MARGIN))
        else:
            assert tt.sph_super.shape == (0, 8)
    if js.n_triangles:
        np.testing.assert_array_equal(tt.tri[:, :21], jt.tri[:, :21])
        np.testing.assert_array_equal(tt.tri[:, tmk.T_ID], tt.tri_map)
        k = tt.tri_box.shape[0]
        np.testing.assert_array_equal(
            tt.tri_box[:, :6], _widened(jt.tri_box, k, tsw.TRI_MARGIN))
        k = tt.tri_super.shape[0]
        np.testing.assert_array_equal(
            tt.tri_super[:, :6], _widened(jt.tri_super, k, tsw.TRI_MARGIN))
    return tt


def test_mega_tables_random_spheres_morton_match_jax():
    js, _ = jpresets.random_spheres()
    ts, _ = tpresets.random_spheres(device="cpu")
    order = tmk.mega_sphere_order(ts.spheres.center.numpy())
    tt = _assert_tables_match(js, ts, None, order)
    assert tt.sph.shape == (496, 16) and tt.sph_box.shape == (31, 8)
    # pad rows repeat the last (Morton-ordered) prim
    assert (tt.sph[484:] == tt.sph[483]).all()


def test_mega_tables_mixed_scene_match_jax():
    js, _ = _mixed_scene()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    tr = ts.triangles
    order = tmk.morton_order(tr.v0.numpy(), tr.v1.numpy(), tr.v2.numpy())
    tt = _assert_tables_match(js, ts, order, None)
    assert tt.tri.shape == (256, 24) and tt.tri_super.shape == (1, 8)
    _assert_tables_match(js, ts, None, None)


def test_mega_tables_two_level_spheres_match_jax():
    """Above SPH_SUPER_MIN spheres the sphere table gains the super level."""
    rng = np.random.default_rng(6)
    centers = rng.uniform(-20, 20, (1100, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.5, 1100).astype(np.float32)

    def fill(b):
        mats = [b.materials.lambertian(color=(0.5, 0.5, 0.5)),
                b.materials.metal((0.9, 0.8, 0.7), 0.1)]
        for k in range(1100):
            b.add_sphere(centers[k], float(radii[k]), mats[k % 2])

    js, ts = _both_builders(fill)
    tt = _assert_tables_match(js, ts, None,
                              tmk.mega_sphere_order(centers))
    assert tt.sph.shape == (1280, 16) and tt.sph_super.shape == (5, 8)


def test_morton_tables_icosphere_match_jax():
    """morton_tables orders both prim types as the JAX orders do; the
    5,120-triangle icosphere fills the two-level triangle tables (20 super
    boxes, 320 chunk boxes) exactly as JAX does."""
    from cudaraytracer_tpu.ops.pallas_intersect import morton_order
    js, ts = _both_builders(cs.fill_icosphere_scene)
    jh = _np_tree(js)
    tri_order = morton_order(jh.triangles.v0, jh.triangles.v1,
                             jh.triangles.v2)
    sph_order = jmk.mega_sphere_order(jh.spheres.center)
    tt = _assert_tables_match(js, ts, tri_order, sph_order)
    for got, ref in zip(to_numpy(tmk.morton_tables(ts)), tt):
        np.testing.assert_array_equal(got, ref)
    assert tt.tri.shape == (5120, 24) and tt.tri_box.shape == (320, 8)
    assert tt.tri_super.shape == (20, 8) and tt.sph.shape == (16, 16)


def test_engine_raises_on_image_textures_and_streamed_sizes(monkeypatch):
    """Image textures are ported (kernel mode K9): the fused engine takes
    random_spheres(textured=True) and its tables hold the scene's images.
    Scenes above the table-resident size take the segment level (K6).
    Above MAX_STREAM_PRIMS (lowered here) the fused entry points raise,
    naming the ceiling, and ``integrate`` renders on the wavefront under
    both fused engines, as JAX's does, dropping the tables it was given;
    so does ``render_image``, which then builds no tables."""
    ts, _ = tpresets.random_spheres(textured=True, device="cpu")
    assert tmk.megakernel_supported(ts)
    tables = tmk.build_mega_tables(ts)
    assert tables.images is ts.textures.images and tmk.has_images(tables)
    b = SceneBuilder()
    m = b.materials.lambertian(color=(1, 1, 1))
    pts, faces = _mesh(7, 50, tmk.MAX_VMEM_PRIMS + 1)
    b.add_mesh(pts, faces, m)
    big = b.build("cpu")
    assert tmk.megakernel_supported(big)
    tables = tmk.build_mega_tables(big)
    assert tables.tri.shape[0] == 10240 and tables.tri_seg.shape == (5, 8)
    monkeypatch.setattr(tmk, "MAX_STREAM_PRIMS", tmk.MAX_VMEM_PRIMS)
    assert not tmk.megakernel_supported(big)
    cfg = RenderConfig(engine="mega", width=4, height=2, samples=1,
                       max_depth=2)
    rng = np.random.default_rng(4)
    n = 32
    rays = make_rays(np.tile([[0.0, 0.0, 3.0]], (n, 1)).astype(np.float32),
                     np.stack([rng.uniform(-0.4, 0.4, n),
                               rng.uniform(-0.4, 0.4, n), -np.ones(n)],
                              1).astype(np.float32), device="cpu")
    ball, prob = _stream_np(2, n, cfg.max_depth)
    stream = SampleStream(torch.from_numpy(ball), torch.from_numpy(prob))
    with pytest.raises(NotImplementedError, match="MAX_STREAM_PRIMS"):
        tmk.trace_path_mega(big, rays, cfg, samples=stream)
    want = tinteg.trace_path(big, rays, dataclasses.replace(
        cfg, engine="wavefront"), samples=stream)
    assert float(want.abs().sum()) > 0.0
    for engine in ("mega", "mega_diff"):
        got = tinteg.integrate(big, rays, dataclasses.replace(
            cfg, engine=engine), tables=tables, samples=stream)
        assert torch.equal(got, want), engine
    camera = make_camera((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), vfov=40.0,
                         aspect=2.0, device="cpu")
    want = render_image(big, camera, dataclasses.replace(
        cfg, engine="wavefront"))
    assert float(want.sum()) > 0.0
    for engine in ("mega", "mega_diff"):
        got = render_image(big, camera, dataclasses.replace(cfg,
                                                            engine=engine))
        assert torch.equal(got, want), engine
