"""The wavefront engine of the port against the JAX package on the CPU: the
sweeps' plain versions (kernels K3, K4, K5) against the JAX raw wrappers,
``intersect_scene_sweeps`` against ``intersect_scene_pallas``, and the three
integrators against JAX's, plus the sweeps' autograd on its own.

Inputs come from a seed through numpy: rays and scenes are made once and
fed to both packages; the scatter stream is JAX's ``stream_from_key``,
injected into both.  The JAX Pallas kernels run in interpret mode, which
``pallas_intersect._interpret()`` picks on the CPU by itself; the K5 path
of JAX needs ``intersect.CONSOLIDATE = True``, set and reset here.

Tolerances:
  * sweeps (t, idx): idx equal on every ray, t to rtol 1e-4.  The port's
    plain versions use the kernels' formulas in the same order, but XLA
    contracts a * b + c into FMAs on the CPU; in the half-b discriminant
    b * b - a * c the cancellation near a silhouette magnifies that to
    2.2e-5 relative (measured on these inputs), and these scenes hold no
    near-ties that such a difference could flip;
  * hit records: idx and the hit mask equal, t / normal / p to atol 1e-4
    (the same FMA difference in t, carried into p and the normal);
  * radiance: atol 2e-4, rtol 1e-4 on every ray, the band that
    tests/test_torch_megakernel.py holds the fused engines to (the same
    FMA difference, carried through a few bounces);
  * autograd against finite differences: torch.autograd.gradcheck's
    defaults in float64 on rays away from silhouettes;
  * the winner sum against JAX's scatter: equal, on values whose every sum
    is exact in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import Quirks as JQuirks
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core.rays import Rays as JRays
from cudaraytracer_tpu.models import presets as jpresets
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import intersect as jisect
from cudaraytracer_tpu.ops import pallas_intersect as jpk
from cudaraytracer_tpu.ops import render as jrender
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core import rng as trng
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import intersect as tisect
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.ops import render as trender
from cudaraytracer_tpu_torch.ops import sweeps as tsw
from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                   scene_from_numpy)
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_megakernel import _mixed_scene

BIG = 3.4028235e38
T_MIN = 1e-3
W, H, SPP, DEPTH = 24, 16, 2, 4


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tq(q):
    return Quirks(**q.__dict__)


def _sphere_set(rng, c, lo=-4.0, hi=4.0):
    center = rng.uniform(lo, hi, (c, 3)).astype(np.float32)
    center[:, 2] -= 8.0
    radius = rng.uniform(0.3, 1.2, c).astype(np.float32)
    return center, radius


def _ray_set(rng, n, spread=0.6):
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                        -np.ones((n, 1))], 1).astype(np.float32)
    return o, d


def _tri_set(rng, c):
    base = rng.uniform(-3, 3, (c, 3)).astype(np.float32)
    base[:, 2] -= 7.0
    v0 = base
    v1 = base + rng.uniform(-1, 1, (c, 3)).astype(np.float32)
    v2 = base + rng.uniform(-1, 1, (c, 3)).astype(np.float32)
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return v0, v1, v2, n.astype(np.float32)


def _assert_hits_equal(got, ref, mask=None):
    t, i = (x.numpy() for x in got)
    rt, ri = (np.asarray(x) for x in ref)
    if mask is not None:
        t, i, rt, ri = t[mask], i[mask], rt[mask], ri[mask]
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(t, rt, rtol=1e-4)
    assert (i >= 0).any()


# ---------------------------------------------------------------------------
# Sweeps: the plain versions against the JAX raw wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("n_rays,n_prims", [(4096, 64), (256, 1040)])
def test_sphere_sweep_plain_matches_jax(cull, n_rays, n_prims):
    """K3 culled and plain; 1,040 spheres cross what were the JAX
    kernel's SEG_PRIMS=1024 segments.  A random alive mask: live lanes
    match, dead lanes are misses in the port (the TPU kernel ran dead
    lanes of a live tile)."""
    rng = np.random.default_rng(n_prims + cull)
    o, d = _ray_set(rng, n_rays)
    center, radius = _sphere_set(rng, n_prims)
    alive = rng.uniform(size=n_rays) < 0.7
    ref = jpk.sphere_best_hit_raw(*map(jnp.asarray, (o, d, center, radius)),
                                  T_MIN, BIG, cull, jnp.asarray(alive))
    got = tsw.sphere_best_hit_raw(*map(_t, (o, d, center, radius)), T_MIN,
                                  BIG, cull, _t(alive))
    _assert_hits_equal(got, ref, alive)
    assert (got[1].numpy()[~alive] == -1).all()
    assert (got[0].numpy()[~alive] == BIG).all()
    full = tsw.sphere_best_hit_raw(*map(_t, (o, d, center, radius)), T_MIN,
                                   BIG, cull)
    _assert_hits_equal(full, jpk.sphere_best_hit_raw(
        *map(jnp.asarray, (o, d, center, radius)), T_MIN, BIG, cull))


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_triangle_sweep_plain_matches_jax(cull, profile):
    """K4 culled and plain under both quirk profiles (the reference
    profile keeps backface-only hits and negative t)."""
    rng = np.random.default_rng(11)
    o, d = _ray_set(rng, 4096, spread=0.5)
    o[:200, 2] = -20.0           # rays that start behind the triangles
    v0, v1, v2, n = _tri_set(rng, 60)
    q = getattr(JQuirks, profile)()
    ref = jpk.triangle_best_hit_raw(*map(jnp.asarray, (o, d, v0, v1, v2, n)),
                                    T_MIN, BIG, q, cull=cull)
    got = tsw.triangle_best_hit_raw(*map(_t, (o, d, v0, v1, v2, n)), T_MIN,
                                    BIG, _tq(q), cull=cull)
    _assert_hits_equal(got, ref)


def test_sphere_attrs_sweep_plain_matches_jax():
    """K5: t, idx and the winner's attribute row; a miss carries prim 0's
    row."""
    rng = np.random.default_rng(5)
    o, d = _ray_set(rng, 2048)
    center, radius = _sphere_set(rng, 40)
    tbl = np.concatenate([center.T, radius[None],
                          rng.uniform(size=(17, 40))]).astype(np.float32)
    for cull in (False, True):
        rt, ri, ra = jpk.sphere_best_hit_attrs_raw(
            *map(jnp.asarray, (o, d, center, radius, tbl)), T_MIN, BIG, cull)
        t, i, a = tsw.sphere_best_hit_attrs_raw(
            *map(_t, (o, d, center, radius, tbl)), T_MIN, BIG, cull)
        _assert_hits_equal((t, i), (rt, ri))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
        assert (a.numpy()[i.numpy() < 0] == tbl[:, 0]).all()


def test_morton_argsort_and_tables_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tsw.morton_argsort(_t(pts)).numpy(),
        np.asarray(jpk.morton_argsort(jnp.asarray(pts))))
    v0, v1, v2, n = _tri_set(rng, 37)
    jv = jpk._pad_tris(*map(jnp.asarray, (v0, v1, v2, n)))
    tbl, box, _ = tsw.triangle_table(*map(_t, (v0, v1, v2, n)))
    np.testing.assert_array_equal(
        tbl.numpy(), np.asarray(jpk._tri_table(*jv))[..., 0].T)
    lo = np.minimum(np.minimum(*jv[:2]), jv[2]).reshape(-1, 16, 3).min(1)
    hi = np.maximum(np.maximum(*jv[:2]), jv[2]).reshape(-1, 16, 3).max(1)
    # JAX's exact chunk boxes, each widened by TRI_MARGIN x its largest
    # |coordinate| (ops/sweeps.py)
    m = np.maximum(abs(lo), abs(hi)).max(1, keepdims=True) * np.float32(
        tsw.TRI_MARGIN)
    np.testing.assert_array_equal(box.numpy()[:, :6],
                                  np.concatenate([lo - m, hi + m], 1))


def test_triangle_table_super_boxes_contain_their_chunks():
    """The super boxes (16 chunks, 256 triangles) that triangle_table
    builds for the two-level cull hold each of their chunks' boxes, the
    last super the ragged end's; each box is its triangles' exact box
    widened by TRI_MARGIN x its largest |coordinate|; and the table's pad
    repeats the last triangle."""
    rng = np.random.default_rng(4)
    v0, v1, v2, n = map(_t, _tri_set(rng, 600))
    tbl, box, sup = tsw.triangle_table(v0, v1, v2, n)
    assert tbl.shape == (608, 12) and box.shape == (38, 8)
    assert sup.shape == (3, 8)
    assert torch.equal(tbl[600:], tbl[599:600].expand(8, 12))
    owner = torch.arange(38) // tsw.CHUNKS_PER_SUPER
    assert bool((sup[owner, :3] <= box[:, :3]).all())
    assert bool((sup[owner, 3:6] >= box[:, 3:6]).all())
    lo = tsw.pad_rows(torch.minimum(torch.minimum(v0, v1), v2), 16)
    hi = tsw.pad_rows(torch.maximum(torch.maximum(v0, v1), v2), 16)
    for level, group in ((box, 16), (sup, 256)):
        for k in range(level.shape[0]):
            blo = lo[k * group:(k + 1) * group].amin(0)
            bhi = hi[k * group:(k + 1) * group].amax(0)
            m = torch.maximum(blo.abs(), bhi.abs()).amax() * tsw.TRI_MARGIN
            assert torch.equal(level[k, :3], blo - m)
            assert torch.equal(level[k, 3:6], bhi + m)


# ---------------------------------------------------------------------------
# Hit records
# ---------------------------------------------------------------------------

def _scene_and_rays(name, seed=3, n=1024):
    js, jc = _mixed_scene() if name == "mixed" else \
        jpresets.three_spheres(aspect=2.0)
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray(jc.origin, np.float32), (n, 1))
    d = np.concatenate([rng.uniform(-0.8, 0.8, (n, 1)),
                        rng.uniform(-0.6, 0.3, (n, 1)),
                        -np.ones((n, 1))], 1).astype(np.float32)
    return js, scene_from_numpy(_np_tree(js), "cpu"), o, d


@pytest.mark.parametrize("profile", ["reference", "fixed"])
@pytest.mark.parametrize("coherent", [False, True])
def test_intersect_sweeps_matches_jax_pallas(profile, coherent):
    js, ts, o, d = _scene_and_rays("mixed")
    q = getattr(JQuirks, profile)()
    ref = jisect.intersect_scene_pallas(
        js, JRays(jnp.asarray(o), jnp.asarray(d), jnp.zeros(len(o))),
        T_MIN, BIG, q, coherent=coherent)
    got = tisect.intersect_scene_sweeps(
        ts, Rays(_t(o), _t(d), torch.zeros(len(o))), T_MIN, BIG, _tq(q),
        coherent=coherent)
    hm = np.asarray(ref.hit)
    assert hm.any() and (~hm).any()
    np.testing.assert_array_equal(got.hit.numpy(), hm)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    for f in ("t", "normal", "p"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hm],
                                   np.asarray(getattr(ref, f))[hm],
                                   atol=1e-4, rtol=1e-6, err_msg=f)
    brute = tisect.intersect_scene(
        ts, Rays(_t(o), _t(d), torch.zeros(len(o))), T_MIN, BIG, _tq(q))
    np.testing.assert_array_equal(brute.prim.numpy(), got.prim.numpy())


def test_sphere_attrs_hits_match_jax_and_finalize():
    """The K5 path (wavefront_kernel_attrs on a pure-sphere scene) builds
    the same record as JAX's consolidated path and as the port's own
    finalize path, its decoded materials included."""
    js, ts, o, d = _scene_and_rays("three_spheres")
    jr = JRays(jnp.asarray(o), jnp.asarray(d), jnp.zeros(len(o)))
    tr = Rays(_t(o), _t(d), torch.zeros(len(o)))
    jisect.CONSOLIDATE = True
    try:
        ref = jisect.intersect_scene_pallas(js, jr, T_MIN, BIG,
                                            JQuirks.reference(),
                                            kernel_attrs=True)
    finally:
        jisect.CONSOLIDATE = None
        jax.clear_caches()
    got = tisect.intersect_scene_sweeps(ts, tr, T_MIN, BIG,
                                        Quirks.reference(),
                                        kernel_attrs=True)
    plain = tisect.intersect_scene_sweeps(ts, tr, T_MIN, BIG,
                                          Quirks.reference())
    hm = got.hit.numpy()
    assert got.dec is not None and plain.dec is None and hm.any()
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(got.prim.numpy(), plain.prim.numpy())
    np.testing.assert_array_equal(got.mat.numpy(), plain.mat.numpy())
    np.testing.assert_array_equal(got.normal.numpy(), plain.normal.numpy())
    np.testing.assert_allclose(got.normal.numpy()[hm],
                               np.asarray(ref.normal)[hm], atol=1e-4)
    dec = tinteg._mat.decode_materials(ts.materials, ts.textures, plain.mat)
    for a, b, r in zip(got.dec, dec, ref.dec):
        np.testing.assert_array_equal(a.numpy()[hm], b.numpy()[hm])
        np.testing.assert_allclose(a.numpy()[hm], np.asarray(r)[hm])


def test_rects_and_trs_raise():
    """Rects and runtime-TRS prims no longer raise: both intersectors take
    them, fold them after the spheres and triangles, and agree (the rect
    of this scene sits behind the sphere on the first ray and alone on the
    second); image textures no longer raise either: the fused engine's
    tables take them and hold the scene's images."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    b = SceneBuilder()
    m = b.materials.lambertian(color=(0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -2), 0.5, m)
    b.add_rect(m, position=(0, 0, -3), scale=(4, 4, 1))
    b.add_sphere((1.5, 0, -2.5), 0.3, m, scale=(1, 2, 1))
    scene = b.build("cpu")
    rays = Rays(torch.zeros(3, 3),
                torch.tensor([[0.0, 0, -1], [0.4, 0.4, -1], [1.5, 0, -2.5]]),
                torch.zeros(3))
    hits = [fn(scene, rays) for fn in (tisect.intersect_scene,
                                       tisect.intersect_scene_sweeps)]
    assert hits[0].prim.tolist() == [0, 1, 2] == hits[1].prim.tolist()
    torch.testing.assert_close(hits[0].t, hits[1].t)
    tb, _ = tpresets.random_spheres(textured=True, device="cpu")
    assert tmk.has_images(tmk.build_mega_tables(tb))


# ---------------------------------------------------------------------------
# Integrators
# ---------------------------------------------------------------------------

def _rays_np(tc, seed, w=W, h=H, spp=SPP):
    from cudaraytracer_tpu_torch.core import camera as tcam
    rng = np.random.default_rng(seed)
    n = w * h * spp
    rays = tcam.generate_pixel_rays(
        tc, w, h, spp, jitter=_t(rng.uniform(size=(n, 2)).astype(np.float32)),
        disk=torch.zeros(n, 3), time_u=torch.zeros(n))
    return tuple(x.numpy() for x in rays)


def _integrate_both(js, jc, integrator, quirks, seed=0, attrs=False,
                    pair=True):
    ts = scene_from_numpy(_np_tree(js), "cpu")
    tc = camera_from_numpy(_np_tree(jc), "cpu")
    o, d, t = _rays_np(tc, seed)
    stream = jinteg.stream_from_key(jax.random.key(seed), o.shape[0], DEPTH)
    jcfg = JConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                   integrator=integrator, quirks=quirks,
                   wavefront_kernel_attrs=attrs)
    tcfg = RenderConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                        integrator=integrator, quirks=_tq(quirks),
                        wavefront_kernel_attrs=attrs)
    jfn = (jrender.pallas_intersector_pair(jcfg) if pair
           else jrender.pallas_intersector(jcfg))
    tfn = (trender.sweep_intersector_pair(tcfg) if pair
           else trender.sweep_intersector(tcfg))
    def run():
        return np.asarray(jinteg.integrate(
            js, JRays(*map(jnp.asarray, (o, d, t))), jax.random.key(9), jcfg,
            jfn, samples=stream))

    if attrs:
        jisect.CONSOLIDATE = True
        try:
            ref = run()
        finally:
            jisect.CONSOLIDATE = None
            jax.clear_caches()
    else:
        ref = run()
    got = tinteg.integrate(
        ts, Rays(*map(_t, (o, d, t))), tcfg, intersect_fn=tfn,
        samples=tinteg.SampleStream(_t(stream.ball), _t(stream.prob)))
    return ref, got.numpy()


@pytest.mark.parametrize("integrator", ["path", "lambert", "normal"])
@pytest.mark.parametrize("scene", ["three_spheres", "mixed"])
def test_integrators_match_jax(scene, integrator):
    js, jc = (jpresets.three_spheres(aspect=2.0) if scene == "three_spheres"
              else _mixed_scene())
    ref, got = _integrate_both(js, jc, integrator, JQuirks.reference(),
                               seed=len(scene), pair=integrator == "path")
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_trace_path_fixed_quirks_and_attrs_match_jax():
    js, jc = _mixed_scene()
    ref, got = _integrate_both(js, jc, "path", JQuirks.fixed(), seed=4)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)
    js, jc = jpresets.three_spheres(aspect=2.0)
    ref, got = _integrate_both(js, jc, "path", JQuirks.reference(), seed=6,
                               attrs=True, pair=False)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_brute_force_and_sweeps_render_alike():
    """The two wavefront intersectors and the fused engine render the
    same image from the same counter-keyed draws (seed per chunk)."""
    scene, cam = tpresets.random_spheres(aspect=2.0, device="cpu")
    cfg = RenderConfig(width=16, height=8, samples=2, max_depth=DEPTH)
    brute = trender.render_image(scene, cam, cfg)
    for isect in (trender.sweep_intersector(cfg),
                  trender.sweep_intersector_pair(cfg)):
        np.testing.assert_allclose(
            trender.render_image(scene, cam, cfg, intersect_fn=isect),
            brute, atol=1e-5)
    mega = trender.render_image(scene, cam,
                                dataclasses.replace(cfg, engine="mega"))
    assert float(((mega - brute).abs() > 1e-3).float().mean()) <= 0.01


def test_default_config_renders_wavefront_on_cpu():
    """RenderConfig() (engine 'wavefront', wavefront_tpu_prng on) renders
    through the port: the counter draws of kernel K2's plain version."""
    cfg = RenderConfig()
    assert cfg.engine == "wavefront" and cfg.wavefront_tpu_prng
    scene, cam = tpresets.three_spheres(aspect=cfg.aspect, device="cpu")
    small = dataclasses.replace(cfg, width=16, height=8, samples=2)
    img = trender.render_image(scene, cam, small)
    assert img.shape == (8, 16, 3) and torch.isfinite(img).all()
    assert 0.05 < float(img.mean()) < 1.0


def test_wavefront_draws():
    """With wavefront_tpu_prng the path draws Philox numbers keyed by
    (seed, ray, bounce), the numbers of kernel K2 and of the fused
    kernel; without it, the generator's; an injected stream wins over
    both."""
    scene, cam = tpresets.three_spheres(aspect=2.0, device="cpu")
    o, d, t = _rays_np(cam, 2, 16, 8, 2)
    rays = Rays(*map(_t, (o, d, t)))
    n = o.shape[0]
    cfg = RenderConfig(width=16, height=8, samples=2, max_depth=DEPTH)
    seed = 0xABCDEF12345
    got = tinteg.trace_path(scene, rays, cfg, seed=seed)
    draws = [trng.counter_draws(seed, torch.arange(n), s)
             for s in range(DEPTH + 1)]
    stream = tinteg.SampleStream(torch.stack([b for b, _ in draws]),
                                 torch.stack([p for _, p in draws]))
    assert torch.equal(got, tinteg.trace_path(scene, rays, cfg,
                                              samples=stream))
    mega = tmk.trace_path_mega(scene, rays,
                               dataclasses.replace(cfg, engine="mega"),
                               seed=seed)
    np.testing.assert_allclose(got, mega, atol=2e-4, rtol=1e-4)
    off = dataclasses.replace(cfg, wavefront_tpu_prng=False)
    a = tinteg.trace_path(scene, rays, off,
                          generator=torch.Generator().manual_seed(1))
    b = tinteg.trace_path(scene, rays, off,
                          generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, got)
    with pytest.raises(ValueError, match="needs samples"):
        tinteg.trace_path(scene, rays, cfg)


# ---------------------------------------------------------------------------
# Autograd of the sweeps
# ---------------------------------------------------------------------------

def _f64(*xs):
    return [torch.tensor(np.asarray(x, np.float64), requires_grad=True)
            for x in xs]


def test_sweep_gradcheck_float64():
    """Winner-only backwards against finite differences, on rays that hit
    well inside a prim (a perturbation never changes the winner)."""
    o, d = _f64([[0.0, 0.1, 0.0], [0.3, -0.1, 0.2], [-0.2, 0.0, 0.1],
                 [0.1, 0.2, -0.1], [5.0, 5.0, 0.0]],
                [[0.05, 0.0, -1.0], [-0.1, 0.05, -1.0], [0.1, 0.1, -1.2],
                 [0.0, -0.1, -0.9], [0.0, 0.0, -1.0]])
    center, radius = _f64([[0.0, 0.0, -4.0], [0.3, 0.1, -6.0]], [1.0, 0.7])

    def sph(o, d, c, r):
        return tsw.sphere_best_hit(o, d, c, r, T_MIN, BIG)[0]

    assert torch.autograd.gradcheck(sph, (o, d, center, radius))
    tbl = torch.cat([center.t(), radius[None],
                     torch.tensor(np.linspace(0, 1, 8).reshape(4, 2),
                                  requires_grad=True)])

    def attrs(o, d, c, r, tb):
        # a miss lane's row 0 carries no gradient by contract (the last ray
        # misses), so only the hit lanes' rows are checked
        t, _, a = tsw.sphere_best_hit_attrs(o, d, c, r, tb, T_MIN, BIG)
        return t, a[:4]

    assert torch.autograd.gradcheck(attrs, (o, d, center, radius,
                                            tbl.detach().requires_grad_()))
    v0, v1, v2 = _f64([[-2.0, -2.0, -3.0]], [[2.0, -2.0, -3.5]],
                      [[0.0, 2.0, -3.2]])
    normal = torch.tensor([[0.0, 0.0, -1.0]], dtype=torch.float64)

    def tri(o, d, a, b, c):
        return tsw.triangle_best_hit(o, d, a, b, c, normal, T_MIN, BIG,
                                     Quirks.fixed())[0]

    assert torch.autograd.gradcheck(tri, (o, d, v0, v1, v2))


@pytest.mark.parametrize("cols,n_slots", [((3, 1, 21), 40), ((3, 3, 3), 7)])
def test_winner_add_plain_matches_jax_scatter(cols, n_slots):
    """The winner sum (K5's blocks: centre, radius, the attribute row; K4's:
    three vertices) against the JAX backward's ``.at[safe].add`` of the
    hit lanes' rows (pallas_intersect.py:1038-1043), misses (-1) and a hot
    winner included, on row blocks that are views (a 1-D column, a
    transposed block of planes).  The values are multiples of 1/8 below 8
    in magnitude, so every sum is exact in float32 whatever its order."""
    rng = np.random.default_rng(sum(cols) + n_slots)
    n = 3000
    idx = rng.integers(-1, n_slots, n).astype(np.int32)
    idx[:600] = -1
    idx[600:1800] = 2
    vals = [(rng.integers(-64, 64, (n, k)) / 8).astype(np.float32)
            for k in cols]
    hit = idx >= 0
    ref = jnp.zeros((n_slots, sum(cols)), jnp.float32).at[
        jnp.maximum(idx, 0)].add(
            jnp.where(hit[:, None], np.concatenate(vals, 1), 0.0))
    blocks = [_t(v[:, 0]) if k == 1 else _t(v) for v, k in zip(vals, cols)]
    blocks[-1] = _t(vals[-1].T).t()          # planes [k, N] seen as [N, k]
    got = tsw.winner_add(_t(idx), blocks, n_slots)
    assert [tuple(g.shape) for g in got] == [
        (n_slots,) if k == 1 else (n_slots, k) for k in cols]
    assert len({g.untyped_storage().data_ptr() for g in got}) == 1
    np.testing.assert_array_equal(
        torch.cat([g.reshape(n_slots, -1) for g in got], 1).numpy(),
        np.asarray(ref))
    assert np.asarray(ref)[2].any()


def test_sweep_gradients_finite_with_degenerate_rays():
    """A miss lane pairs with triangle 0 in the backward; a ray parallel
    to its plane (a = 0) must not poison the scatter-add with NaN
    (tests/test_pallas.py::test_triangle_bwd_no_nan_from_miss_rays), and
    the brute-force path's 1/a is guarded the same way
    (tests/test_intersect.py::
    test_intersect_gradients_finite_with_degenerate_rays)."""
    v0 = torch.tensor([[-1.0, 0.0, -3.0], [2.0, 0.0, -5.0]],
                      requires_grad=True)
    v1 = torch.tensor([[1.0, 0.0, -3.0], [3.0, 0.0, -5.0]],
                      requires_grad=True)
    v2 = torch.tensor([[0.0, 1.5, -3.0], [2.5, 1.5, -5.0]],
                      requires_grad=True)
    nrm = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    o = torch.tensor([[0.0, 0.5, 0.0], [10.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    t, idx = tsw.triangle_best_hit(o, d, v0, v1, v2, nrm, 1e-3, 1e9,
                                   Quirks.fixed())
    torch.where(idx >= 0, t, 0.0).sum().backward()
    for g in (v0.grad, v1.grad, v2.grad):
        assert torch.isfinite(g).all()
    assert float(v0.grad.abs().max()) > 0

    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    b = SceneBuilder()
    mat = b.materials.lambertian(color=(0.5, 0.5, 0.5))
    b.add_triangle((-1, 0, -3), (1, 0, -3), (0, 0, -5), mat,
                   normal=(0, 1, 0))
    scene = b.build("cpu")
    tv0 = scene.triangles.v0.clone().requires_grad_()
    oo = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.5, 0.0]], requires_grad=True)
    dd = torch.tensor([[0.0, -0.25, -1.0], [0.0, 0.0, -1.0]])
    for fn in (tisect.intersect_scene, tisect.intersect_scene_sweeps):
        hits = fn(scene._replace(triangles=scene.triangles._replace(v0=tv0)),
                  Rays(oo, dd, torch.zeros(2)), quirks=Quirks.fixed())
        assert bool(hits.hit[0]) and not bool(hits.hit[1])
        g = torch.autograd.grad(
            torch.where(hits.hit, hits.t, 0.0).sum() + hits.u.sum(),
            (tv0, oo))
        assert all(torch.isfinite(x).all() for x in g)


def test_checkpointed_bounces_give_the_same_gradients():
    """Each bounce is recomputed in the backward; the draws are made
    outside the recomputed function, so with generator draws too the
    gradients equal those of the stored graph."""
    scene, cam = tpresets.three_spheres(aspect=2.0, device="cpu")
    o, d, t = _rays_np(cam, 8, 12, 8, 2)
    rays = Rays(*map(_t, (o, d, t)))
    for tpu_prng in (True, False):
        cfg = RenderConfig(width=12, height=8, samples=2, max_depth=3,
                           wavefront_tpu_prng=tpu_prng,
                           wavefront_kernel_attrs=True)
        isect = trender.sweep_intersector_pair(cfg)
        grads = []
        for ckpt in (True, False):
            albedo = scene.textures.color0.clone().requires_grad_()
            center = scene.spheres.center.clone().requires_grad_()
            s = scene._replace(
                textures=scene.textures._replace(color0=albedo),
                spheres=scene.spheres._replace(center=center))
            out = tinteg.trace_path(
                s, rays, cfg, isect, seed=5,
                generator=torch.Generator().manual_seed(3), checkpoint=ckpt)
            grads.append(torch.autograd.grad(out.square().mean(),
                                             (albedo, center)))
        for a, b in zip(*grads):
            assert float(a.abs().max()) > 0
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
