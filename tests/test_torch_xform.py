"""Rects and runtime-TRS prims in the port against the JAX package on the
CPU: the TransformRay, the candidate tests and the hit records of the
wavefront (``ops/intersect.py``), and the fused engine's plain version of
kernel mode K8 against JAX ``trace_path_mega`` (its ``_mega_kernel`` in
interpret mode) or, above the JAX engine's 1024-per-class cap, against the
JAX wavefront.

Scenes are built by the JAX SceneBuilder (the JAX tests' own showcase and
TRS scenes, light_box) and carried across with ``scene_from_numpy``; rays
come from numpy jitter through the port's camera, and the scatter stream
from numpy, injected into both packages.

Tolerances:
  * candidates: valid masks equal; hit records: winner ids equal on all
    but 0.5% of rays (measured: 1 of 2,048 aimed rays, a grazing hit);
    t / p / normal / u / v to atol 1e-4 and rtol 1e-4 (t reaches 16 on
    these rays, measured relative difference 1e-5) where the winners agree
    (XLA
    contracts a * b + c into FMAs on the CPU and PyTorch does not; the
    TransformRay's renormalization and the rotation add a few roundings
    over the plain sphere test);
  * radiance: atol 3e-4 on every ray, as tests/test_transform_prims.py:164
    holds the JAX engines to each other, except that at most 0.5% of rays
    may exceed it where the FMA difference flips a grazing hit (the count
    is printed by the assertion).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import Quirks as JQuirks
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core import camera as jcam
from cudaraytracer_tpu.core.rays import Rays as JRays
from cudaraytracer_tpu.models import presets as jpresets
from cudaraytracer_tpu.models import transform as jtf
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import intersect as jisect
from cudaraytracer_tpu.ops import megakernel as jmk
from cudaraytracer_tpu_torch.apps import render as render_app
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core import camera as tcam
from cudaraytracer_tpu_torch.core import vec as tv3
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.models import transform as ttf
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import intersect as tisect
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.ops.integrators import SampleStream
from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                   scene_from_numpy, to_numpy)
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_transform_prims import _trs_showcase_scene

W, H, SPP, DEPTH = 32, 16, 1, 4
ATOL = 3e-4
HIT_ATOL = 1e-4
INTEGRATORS = ("path", "lambert", "normal")


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _showcase():
    """tests/test_transform_prims.py:116-135: two runtime-TRS spheres (one
    checker), a runtime-TRS metal triangle, a ground sphere and a rect
    light; its camera (:148)."""
    return _trs_showcase_scene(), jcam.make_camera(
        (0, 0.3, 1), (0, 0, -3), vfov=55, aspect=2.0, focus_dist=4.0)


def above_cap_scene(k: int):
    """``fill_trs_field`` (the generator of
    tests/test_transform_prims.py:168-207) with ``k`` each of TRS spheres,
    TRS triangles and rects, built by the JAX SceneBuilder."""
    cam = jcam.make_camera((0, 0.3, 1), (0, 0.3, -3), vfov=60, aspect=2.0,
                           focus_dist=4.0)
    return cs.fill_trs_field(JSceneBuilder(), k).build(), cam


def _inputs(jc, seed, w=W, h=H, spp=SPP, depth=DEPTH):
    """Rays (numpy jitter through the port's camera; none without a camera)
    and a numpy stream."""
    rng = np.random.default_rng(seed)
    n = w * h * spp
    rays = ()
    if jc is not None:
        rays = tcam.generate_pixel_rays(
            camera_from_numpy(_np_tree(jc), "cpu"), w, h, spp,
            jitter=torch.from_numpy(rng.uniform(size=(n, 2)).astype(
                np.float32)),
            disk=torch.zeros(n, 3), time_u=torch.zeros(n))
    g = rng.standard_normal((depth + 1, n, 3))
    r = rng.uniform(size=(depth + 1, n, 1)) ** (1.0 / 3.0)
    ball = (g / np.linalg.norm(g, axis=-1, keepdims=True) * r)
    prob = rng.uniform(size=(depth + 1, n))
    return (tuple(x.numpy() for x in rays), ball.astype(np.float32),
            prob.astype(np.float32))


def _aimed_rays(js, seed, n, origin=(0.0, 0.3, 1.0)):
    """Rays from near ``origin`` at the world points of the scene's rect
    and TRS prims (an object point q sits at R^T (q + position), the
    reference chain rotating about the world origin), with unnormalized
    directions of length 0.5 to 3."""
    rng = np.random.default_rng(seed)
    o = np.asarray(origin) + rng.normal(scale=0.2, size=(n, 3))
    dirs = []
    for trs, q in ((js.rects.trs, rng.uniform(-0.6, 0.6, (n, 3)) * [1, 1, 0]),
                   (js.t_spheres.trs, rng.normal(scale=0.5, size=(n, 3))),
                   (js.t_triangles.trs, rng.normal(scale=0.5, size=(n, 3)))):
        if not len(trs.position):
            continue
        k = rng.integers(0, len(trs.position), n)
        R = np.asarray(jtf.v3.rotation_matrix_euler_deg(
            jnp.asarray(trs.rotation)))[k]
        target = np.einsum("nji,nj->ni", R, q + np.asarray(trs.position)[k])
        # ScaleRay divides the direction by the scale (not the origin)
        dirs.append((target - o) * np.asarray(trs.scale)[k])
    cls = rng.integers(0, len(dirs), (n, 1))
    d = np.select([cls == c for c in range(len(dirs))], dirs)
    d *= rng.uniform(0.5, 3.0, (n, 1)) / np.linalg.norm(d, axis=1,
                                                        keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            np.zeros(n, np.float32))


def _both(rays_np, ball, prob):
    o, d, t = rays_np
    return ((JRays(*map(jnp.asarray, (o, d, t))),
             jinteg.SampleStream(jnp.asarray(ball), jnp.asarray(prob))),
            (Rays(*map(torch.from_numpy, (o, d, t))),
             SampleStream(torch.from_numpy(ball), torch.from_numpy(prob))))


def _tcfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["quirks"] = Quirks(**jcfg.quirks.__dict__)
    return RenderConfig(**kw)


def _assert_radiance(got, ref, atol=ATOL, share=0.005):
    assert np.isfinite(got).all()
    diff = np.abs(got - ref).max(axis=1)
    bad = int((diff > atol).sum())
    assert bad <= share * diff.shape[0], (bad, float(diff.max()))


# ---------------------------------------------------------------------------
# TransformRay, candidates, hit records
# ---------------------------------------------------------------------------

def test_transform_ray_matches_jax():
    """transform_arrays (the chain the candidates, the fused plain version
    and K8 share) against JAX transform_ray: origin and unit direction."""
    rng = np.random.default_rng(0)
    o = rng.normal(size=(64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    pos = rng.normal(size=(64, 3)).astype(np.float32)
    rot = rng.uniform(-180, 180, (64, 3)).astype(np.float32)
    scl = rng.uniform(0.3, 3.0, (64, 3)).astype(np.float32)
    ref = jtf.transform_ray(jtf.TRS(*map(jnp.asarray, (pos, rot, scl))),
                            JRays(*map(jnp.asarray, (o, d, np.zeros(64)))))
    R = tv3.rotation_matrix_euler_deg(torch.from_numpy(rot))
    cols = [torch.from_numpy(x) for x in (o, d, pos, scl)]
    xo, xd = ttf.transform_arrays(
        *([c[:, k] for k in range(3)] for c in cols),
        [R[:, i, j] for i in range(3) for j in range(3)])
    for got, want in ((xo, ref.origin), (xd, ref.direction)):
        np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)
    assert np.allclose(torch.stack(xd, 1).norm(dim=1).numpy(), 1.0,
                       atol=1e-6)


@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_candidates_match_jax(profile):
    """rect_candidates, t_sphere_candidates, t_triangle_candidates: the
    showcase's prims against rays from its camera."""
    js, _ = _showcase()
    quirks = getattr(JQuirks, profile)()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    (jr, _), (tr, _) = _both(_aimed_rays(js, 1, 512), *_inputs(None, 1)[1:])
    t_min, t_max = np.float32(1e-3), np.float32(3.4028235e38)
    pairs = [
        (jisect.rect_candidates(jr, js.rects, t_min, t_max),
         tisect.rect_candidates(tr, ts.rects, float(t_min), float(t_max))),
        (jisect.t_sphere_candidates(jr, js.t_spheres, t_min, t_max),
         tisect.t_sphere_candidates(tr, ts.t_spheres, float(t_min),
                                    float(t_max))),
        (jisect.t_triangle_candidates(jr, js.t_triangles, t_min, t_max,
                                      quirks),
         tisect.t_triangle_candidates(tr, ts.t_triangles, float(t_min),
                                      float(t_max),
                                      Quirks(**quirks.__dict__)))]
    for k, (ref, got) in enumerate(pairs):
        valid = np.asarray(ref[0])
        np.testing.assert_array_equal(got[0].numpy(), valid)
        # under the reference's backface-only quirk these rays, which see
        # the TRS triangle's front, all miss it
        assert valid.any() or (k == 2 and profile == "reference")
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid],
                                       atol=HIT_ATOL, rtol=1e-5)


@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_hit_records_match_jax(profile):
    """Brute force and the sweeps (rects and TRS prims folded in by tensor
    ops) against JAX intersect_scene: winners, the object-space point, the
    rotated normal, u, v and the material, on rays aimed at the showcase's
    TRS prims and at light_box's rect light."""
    quirks = getattr(JQuirks, profile)()
    tq = Quirks(**quirks.__dict__)
    js, _ = _showcase()
    lb, _ = jpresets.light_box(aspect=2.0)
    seen = set()
    # light_box's rect faces -z (flipped), away from its camera: aim from
    # under it, where bounced rays reach it (from above the floor, whose
    # 1000-radius quadratic cancels badly for an origin on its surface)
    for scene, rays in ((js, _aimed_rays(js, 2, 2048)),
                        (lb, _aimed_rays(lb, 3, 1024, (0.0, 1.2, 2.2)))):
        ts = scene_from_numpy(_np_tree(scene), "cpu")
        (jr, _), (tr, _) = _both(rays, *_inputs(None, 2)[1:])
        ref = jisect.intersect_scene(scene, jr, quirks=quirks)
        for got in (tisect.intersect_scene(ts, tr, quirks=tq),
                    tisect.intersect_scene_sweeps(ts, tr, quirks=tq)):
            same = got.prim.numpy() == np.asarray(ref.prim)
            assert (~same).sum() <= 0.005 * same.size, int((~same).sum())
            hit = np.asarray(ref.hit) & same
            for name in ("t", "p", "normal", "u", "v"):
                np.testing.assert_allclose(
                    getattr(got, name).numpy()[hit],
                    np.asarray(getattr(ref, name))[hit], atol=HIT_ATOL,
                    rtol=1e-4, err_msg=name)
            np.testing.assert_array_equal(got.mat.numpy()[hit],
                                          np.asarray(ref.mat)[hit])
        base = ts.n_spheres + ts.n_triangles
        seen |= {("rect", "tsph", "tsph", "ttri")[min(p - base, 3)]
                 for p in np.asarray(ref.prim).tolist() if p >= base}
    assert seen >= ({"rect", "tsph", "ttri"} if profile == "fixed"
                    else {"rect", "tsph"}), seen


def test_trs_sphere_record_is_not_a_rects():
    """The rect block of finalize_hits has an upper id bound
    (tests/test_transform_prims.py:248): a winning TRS sphere keeps its own
    u, v and object-space point in a scene that also holds a rect."""
    b = JSceneBuilder()
    mat = b.materials.lambertian(color=(1, 1, 1))
    b.add_rect(mat, position=(50, 0, -3), scale=(9, 9, 1))
    b.add_sphere((0, 0, -3), 1.0, mat, rotation=(0, 0, 45))
    js = b.build()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    o = np.zeros((2, 3), np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.1, 0.05, -1.0]], np.float32)
    ref = jisect.intersect_scene(js, JRays(jnp.asarray(o), jnp.asarray(d),
                                           jnp.zeros(2)))
    got = tisect.intersect_scene(ts, Rays(torch.from_numpy(o),
                                          torch.from_numpy(d),
                                          torch.zeros(2)))
    assert got.prim.tolist() == [1, 1] == np.asarray(ref.prim).tolist()
    # get_sphere_uv of the normal (0, 0, 1): u = 0.25, v = 1
    np.testing.assert_allclose([float(got.u[0]), float(got.v[0])],
                               [0.25, 1.0], atol=1e-5)
    for name in ("t", "p", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=HIT_ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# The fused engine (K8's plain version)
# ---------------------------------------------------------------------------

def _fused_pair(js, jc, jcfg, seed, tables_order=True):
    """(JAX trace_path_mega, the port's fused plain version) on the same
    rays, Morton tables and injected stream."""
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    (jr, jst), (tr, tst) = _both(*_inputs(jc, seed, jcfg.width, jcfg.height,
                                          jcfg.samples, jcfg.max_depth))
    orders = tmk.mega_orders(tree) if tables_order else (None, None)
    jt = jmk.build_mega_tables(js, tri_order=orders[0], sph_order=orders[1])
    ref = np.asarray(jmk.trace_path_mega(js, jr, jax.random.key(0), jcfg,
                                         tables=jt, samples=jst))
    got = tmk.trace_path_mega(ts, tr, _tcfg(jcfg),
                              tables=tmk.build_mega_tables(ts, *orders),
                              samples=tst)
    return ref, got.numpy()


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_fused_showcase_matches_jax(profile, integrator):
    """The TRS showcase (tests/test_transform_prims.py:138) under both quirk
    profiles and all three integrators."""
    js, jc = _showcase()
    jcfg = JConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                   integrator=integrator,
                   quirks=getattr(JQuirks, profile)(), engine="mega")
    ref, got = _fused_pair(js, jc, jcfg, 3)
    assert ref.std() > 0.05
    _assert_radiance(got, ref)


def test_fused_light_box_matches_jax():
    js, jc = jpresets.light_box(aspect=2.0)
    jcfg = JConfig(width=W, height=H, samples=2, max_depth=DEPTH,
                   engine="mega")
    ref, got = _fused_pair(js, jc, jcfg, 4)
    assert (ref > 1.0).any()          # the rect light is in view
    _assert_radiance(got, ref)


def test_fused_above_cap_matches_jax_wavefront():
    """More than the JAX engine's 1024 prims per class (MAX_TRS_PRIMS): the
    port's fused plain version against the JAX wavefront, and against its
    own wavefront; the fused JAX engine does not take the scene."""
    js, jc = above_cap_scene(1030)
    assert not jmk.megakernel_supported(js)
    ts = scene_from_numpy(_np_tree(js), "cpu")
    assert tmk.megakernel_supported(ts)
    cfg = JConfig(width=24, height=12, samples=1, max_depth=3,
                  quirks=JQuirks.fixed())
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 5, 24, 12, 1, 3))
    ref = np.asarray(jinteg.trace_path(js, jr, jax.random.key(0), cfg,
                                       samples=jst))
    tcfg = _tcfg(cfg)
    got = tmk.trace_path_mega(ts, tr, dataclasses.replace(tcfg,
                                                          engine="mega"),
                              tables=tmk.morton_tables(ts), samples=tst)
    with torch.no_grad():
        wave = tinteg.trace_path(ts, tr, tcfg, samples=tst)
    assert ref.std() > 0.03
    _assert_radiance(got.numpy(), ref)
    _assert_radiance(wave.numpy(), ref)


def test_light_box_renders_through_the_cli(tmp_path, capsys):
    for accel in ("mega", "sweeps"):
        out = tmp_path / f"{accel}.png"
        assert render_app.main(["--cpu", "--scene", "light_box", "--width",
                                "16", "--height", "8", "--spp", "1",
                                "--max-depth", "3", "--accel", accel,
                                "--out", str(out)]) == 0
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert f"{accel} on cpu" in capsys.readouterr().out


def test_mega_tables_hold_the_rect_and_trs_rows():
    """The K8 tables: the JAX rows' columns in the port's cut layout, no
    padding, and the row -> scene maps of the Morton-ordered tables."""
    js, _ = _showcase()
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    orders = tmk.mega_orders(tree)
    jt = _np_tree(jmk.build_mega_tables(js, tri_order=orders[0],
                                        sph_order=orders[1]))
    tt = to_numpy(tmk.build_mega_tables(ts, *orders))
    assert tt.rect.shape == (1, tmk.RECT_COLS)
    assert tt.tsph.shape == (2, tmk.TSPH_COLS)
    assert tt.ttri.shape == (1, tmk.TTRI_COLS)
    np.testing.assert_array_equal(tt.sph_map, jt.sph_map[:tt.sph.shape[0]])
    # JAX rect lanes: sgn 0, pos 1, scl 4, rot 7, nrm 16, mat 19
    np.testing.assert_allclose(tt.rect[:, tmk.RECT_SGN], jt.rect[:1, 0])
    for (a, b, k) in ((tmk.X_POS, 1, 3), (tmk.X_SCL, 4, 3), (tmk.X_ROT, 7, 9),
                      (tmk.RECT_NRM, 16, 3), (tmk.X_MAT, 19, 9)):
        np.testing.assert_allclose(tt.rect[:, a:a + k], jt.rect[:1, b:b + k],
                                   atol=1e-6)
    # TRS spheres: pos 0, scl 3, rot 6, r2 15, 1/r 16, mat 17
    for (a, b, k) in ((tmk.X_POS, 0, 3), (tmk.X_SCL, 3, 3), (tmk.X_ROT, 6, 9),
                      (tmk.TSPH_R2, 15, 2), (tmk.X_MAT, 17, 9)):
        np.testing.assert_allclose(tt.tsph[:, a:a + k], jt.tsph[:2, b:b + k],
                                   atol=1e-6)
    # TRS triangles: v0 e1 e2 nobj nw 0-14, pos 15, scl 18, rot 21, mat 30
    for (a, b, k) in ((tmk.TTRI_V0, 0, 15), (tmk.X_POS, 15, 3),
                      (tmk.X_SCL, 18, 3), (tmk.X_ROT, 21, 9),
                      (tmk.X_MAT, 30, 9)):
        np.testing.assert_allclose(tt.ttri[:, a:a + k], jt.ttri[:1, b:b + k],
                                   atol=1e-6)
