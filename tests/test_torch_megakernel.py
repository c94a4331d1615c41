"""The fused path tracer: the port's plain version against the JAX
megakernel on the CPU, and (marked ``gpu``) the CUDA kernel against the
plain version on the card.

Inputs are made with numpy from a seed: camera rays from numpy jitter, and
an injected scatter stream (unit-ball samples and uniforms) that both
packages read, so the two compute on the same numbers.

Tolerances:
  * small scenes (three_spheres, the mixed sphere + triangle scene):
    atol 2e-4, rtol 1e-4 on every ray, as tests/test_megakernel.py holds the
    JAX engines to each other;
  * random_spheres: at most 0.5% of rays differ by more than 1e-3 (path,
    lambert).  XLA contracts a * b + c into FMAs on the CPU and PyTorch does
    not, and at this scene's distances that flips grazing hits.  The normal
    integrator's output is the normal (p - c) / r of 0.2-radius spheres
    seen from ~15 units, which scales the quadratic's rounding by about
    |d| / r = 50: it is held at 1e-2 instead (measured on these inputs:
    27 of 1024 rays differ by more than 1e-3, none by more than 1e-2, at
    most 5.2e-3; path: 3 of 1024 over 1e-3).

The CUDA kernel is held against this plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import Quirks as JQuirks
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core.rays import Rays as JRays
from cudaraytracer_tpu.models import presets as jpresets
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import megakernel as jmk
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core import camera as tcam
from cudaraytracer_tpu_torch.core import rng as trng
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.models.scene import SceneBuilder
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.ops.integrators import SampleStream
from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                   scene_from_numpy)
from test_megakernel import _mixed_scene

W, H, SPP, DEPTH = 32, 16, 2, 8
INTEGRATORS = ("path", "lambert", "normal")


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _rays_np(camera, seed, w=W, h=H, spp=SPP):
    """Camera rays from numpy jitter (the port's camera, fed draws)."""
    rng = np.random.default_rng(seed)
    n = w * h * spp
    jitter = rng.uniform(size=(n, 2)).astype(np.float32)
    disk = trng.disk_from_uniforms(torch.from_numpy(
        rng.uniform(size=(n, 2)).astype(np.float32)))
    rays = tcam.generate_pixel_rays(camera, w, h, spp,
                                    jitter=torch.from_numpy(jitter),
                                    disk=disk, time_u=torch.zeros(n))
    return tuple(x.numpy() for x in rays)


def _stream_np(seed, n, depth=DEPTH):
    """Unit-ball samples and uniforms for every (bounce, ray), from numpy."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((depth + 1, n, 3))
    r = rng.uniform(size=(depth + 1, n, 1)) ** (1.0 / 3.0)
    ball = (g / np.linalg.norm(g, axis=-1, keepdims=True) * r)
    prob = rng.uniform(size=(depth + 1, n))
    return ball.astype(np.float32), prob.astype(np.float32)


def _jcfg(integrator, quirks, w=W, h=H, spp=SPP):
    return JConfig(width=w, height=h, samples=spp, max_depth=DEPTH,
                   integrator=integrator, quirks=quirks, engine="mega")


def _tcfg(integrator, quirks, w=W, h=H, spp=SPP):
    return RenderConfig(width=w, height=h, samples=spp, max_depth=DEPTH,
                        integrator=integrator, engine="mega",
                        quirks=Quirks(**quirks.__dict__))


def _jax_and_port(js, jc, integrator, quirks, seed=0):
    """(JAX trace_path_mega, port trace_path_mega on the CPU) radiance on
    the same rays, Morton tables and injected stream."""
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    tc = camera_from_numpy(_np_tree(jc), "cpu")
    o, d, t = _rays_np(tc, seed)
    ball, prob = _stream_np(seed + 1, o.shape[0])
    tri_order, sph_order = tmk.mega_orders(tree)
    jt = jmk.build_mega_tables(js, tri_order=tri_order, sph_order=sph_order)
    ref = np.asarray(jmk.trace_path_mega(
        js, JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t)),
        jax.random.key(0), _jcfg(integrator, quirks), tables=jt,
        samples=jinteg.SampleStream(jnp.asarray(ball), jnp.asarray(prob))))
    tt = tmk.build_mega_tables(ts, tri_order, sph_order)
    got = tmk.trace_path_mega(
        ts, Rays(*(torch.from_numpy(x) for x in (o, d, t))),
        _tcfg(integrator, quirks), tables=tt,
        samples=SampleStream(torch.from_numpy(ball), torch.from_numpy(prob)))
    return ref, got.numpy()


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_plain_matches_jax_three_spheres(integrator):
    js, jc = jpresets.three_spheres(aspect=2.0)
    ref, got = _jax_and_port(js, jc, integrator, JQuirks.reference())
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_plain_matches_jax_mixed_scene(integrator, profile):
    js, jc = _mixed_scene()
    quirks = getattr(JQuirks, profile)()
    ref, got = _jax_and_port(js, jc, integrator, quirks, seed=3)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_plain_matches_jax_random_spheres(integrator):
    js, jc = jpresets.random_spheres(aspect=2.0)
    ref, got = _jax_and_port(js, jc, integrator, JQuirks.reference(),
                             seed=5)
    tol = 1e-2 if integrator == "normal" else 1e-3
    diff = np.abs(got - ref).max(axis=1)
    assert np.isfinite(got).all()
    assert (diff > tol).mean() <= 0.005, (int((diff > tol).sum()),
                                         float(diff.max()))


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_duplicate_prims_first_wins(integrator):
    """Exact copies of prims change nothing (first-prim-wins survives
    Morton order and padding), and the port agrees with JAX on the
    duplicate scene."""
    js = cs.fill_duplicate_scene(JSceneBuilder(), True).build()
    jc = jpresets.three_spheres(aspect=2.0)[1]
    ref, got = _jax_and_port(js, jc, integrator, JQuirks.fixed(), seed=7)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)
    single = cs.fill_duplicate_scene(SceneBuilder(), False).build("cpu")
    dup = cs.fill_duplicate_scene(SceneBuilder(), True).build("cpu")
    cam = camera_from_numpy(_np_tree(jc), "cpu")
    o, d, t = _rays_np(cam, 7)
    ball, prob = _stream_np(8, o.shape[0])
    rays = Rays(*(torch.from_numpy(x) for x in (o, d, t)))
    stream = SampleStream(torch.from_numpy(ball), torch.from_numpy(prob))
    cfg = _tcfg(integrator, JQuirks.fixed())
    outs = []
    for scene in (single, dup):
        tables = tmk.morton_tables(scene)
        outs.append(tmk.trace_path_mega(scene, rays, cfg, tables=tables,
                                        samples=stream))
    assert torch.equal(outs[0], outs[1])


def test_in_kernel_draws_equal_injected_counter_stream():
    """Without a stream the path integrator draws Philox numbers keyed by
    (seed, ray index, bounce); injecting the same numbers gives the same
    image, and the ray chunking of the plain version does not change
    them."""
    scene, cam = tpresets.three_spheres(aspect=2.0, device="cpu")
    o, d, t = _rays_np(cam, 9)
    rays = Rays(*(torch.from_numpy(x) for x in (o, d, t)))
    n = o.shape[0]
    cfg = _tcfg("path", JQuirks.reference())
    seed = 0x1234_5678_9ABC
    got = tmk.trace_path_mega(scene, rays, cfg, seed=seed)
    draws = [trng.counter_draws(seed, torch.arange(n), s)
             for s in range(DEPTH + 1)]
    stream = SampleStream(torch.stack([b for b, _ in draws]),
                          torch.stack([p for _, p in draws]))
    assert torch.equal(got, tmk.trace_path_mega(scene, rays, cfg,
                                                samples=stream))
    tables = tmk.build_mega_tables(scene)
    parts = [tmk._plain_rays(tables, rays.origin[lo:lo + 100],
                             rays.direction[lo:lo + 100], cfg, None, seed,
                             torch.arange(lo, min(n, lo + 100)))
             for lo in range(0, n, 100)]
    assert torch.equal(got, torch.cat(parts))
    gen = torch.Generator().manual_seed(4)
    assert torch.isfinite(tmk.trace_path_mega(scene, rays, cfg,
                                              generator=gen)).all()
    with pytest.raises(ValueError, match="needs samples"):
        tmk.trace_path_mega(scene, rays, cfg)


def test_scatter_draws_plain_on_cpu_tensor():
    out = torch.empty(1000, 4)
    tmk.scatter_draws(out, 77, 2)
    ball, prob = trng.counter_draws(77, torch.arange(1000), 2)
    assert torch.equal(out, torch.cat([ball, prob[:, None]], 1))
    assert tmk.LAUNCHES["scatter_draws"] == 0


@pytest.mark.parametrize("morton", [False, True])
def test_exact_ties_first_sphere_wins(morton):
    """Sphere B beats a triangle hit at exactly the same t, and sphere A
    beats its copy A' in a later chunk, in both packages."""
    js = cs.fill_tie_scene(JSceneBuilder()).build()
    ts = cs.fill_tie_scene(SceneBuilder()).build("cpu")
    sph_order = (tmk.mega_sphere_order(ts.spheres.center.numpy()) if morton
                 else None)
    o, d = cs.TIE_ORIGINS, cs.TIE_DIRECTIONS
    jt = jmk.build_mega_tables(js, sph_order=sph_order)
    ref = np.asarray(jmk.trace_path_mega(
        js, JRays(jnp.asarray(o), jnp.asarray(d), jnp.zeros(2)),
        jax.random.key(0), JConfig(max_depth=0, quirks=JQuirks.fixed(),
                                   engine="mega"), tables=jt))
    got = tmk.trace_path_mega(
        ts, Rays(torch.from_numpy(o), torch.from_numpy(d), torch.zeros(2)),
        RenderConfig(max_depth=0, quirks=Quirks.fixed(), engine="mega"),
        tables=tmk.build_mega_tables(ts, None, sph_order), seed=0)
    np.testing.assert_array_equal(ref, cs.TIE_EXPECTED)
    np.testing.assert_array_equal(got.numpy(), cs.TIE_EXPECTED)
