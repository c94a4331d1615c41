"""The port's core modules (config, vec, rays, rng, camera, image writer,
screen swizzle) against the JAX package on the same numpy-made inputs.

Tolerances: elementwise float32 math that both packages evaluate with the
same operations is held at atol 1e-6 (1-2 ulp at the magnitudes used);
integer and byte outputs are held exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.core import camera as jcam
from cudaraytracer_tpu.core import rng as jrng
from cudaraytracer_tpu.core import vec as jvec
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import render as jrender
from cudaraytracer_tpu.utils import image as jimage
from cudaraytracer_tpu_torch import config as tconfig
from cudaraytracer_tpu_torch.core import camera as tcam
from cudaraytracer_tpu_torch.core import rng as trng
from cudaraytracer_tpu_torch.core import vec as tvec
from cudaraytracer_tpu_torch.core.rays import make_rays
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.models.scene import SceneBuilder
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import render as trender
from cudaraytracer_tpu_torch.utils import image as timage
from cudaraytracer_tpu_torch.utils.convert import camera_from_numpy


def _t(x):
    return torch.from_numpy(np.array(x))


def _vecs(seed, n=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))


@pytest.mark.parametrize("name", ["dot", "vdot", "cross", "length",
                                  "squared_length", "unit_vector",
                                  "normalize_safe", "reflect", "clip01"])
def test_vec_binary_and_unary_match_jax(name):
    a, b = _vecs(0)
    fj, ft = getattr(jvec, name), getattr(tvec, name)
    two = name in ("dot", "vdot", "cross", "reflect")
    ref = np.asarray(fj(a, b) if two else fj(a))
    got = (ft(_t(a), _t(b)) if two else ft(_t(a))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_vec_lerp_slerp_refract_schlick_match_jax():
    a, b = _vecs(1)
    t = np.random.default_rng(2).uniform(size=64).astype(np.float32)
    np.testing.assert_allclose(tvec.lerp(_t(t), _t(a), _t(b)).numpy(),
                               np.asarray(jvec.lerp(t, a, b)), atol=1e-6)
    np.testing.assert_allclose(tvec.slerp(_t(a), _t(b), _t(t)).numpy(),
                               np.asarray(jvec.slerp(a, b, t)), atol=1e-5)
    n = a / np.linalg.norm(a, axis=-1, keepdims=True)
    ok_j, r_j = jvec.refract(b, n, 1.0 / 1.5)
    ok_t, r_t = tvec.refract(_t(b), _t(n), 1.0 / 1.5)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-6)
    np.testing.assert_allclose(
        tvec.schlick(_t(t), torch.tensor(1.5)).numpy(),
        np.asarray(jvec.schlick(t, 1.5)), atol=1e-6)


def test_rotation_matrix_and_rotate_match_jax():
    rot = np.random.default_rng(3).uniform(-180, 180, (16, 3)).astype(
        np.float32)
    v, _ = _vecs(4, 16)
    np.testing.assert_allclose(tvec.rotation_matrix_euler_deg(_t(rot)).numpy(),
                               np.asarray(jvec.rotation_matrix_euler_deg(rot)),
                               atol=1e-6)
    np.testing.assert_allclose(tvec.rotate(_t(v), _t(rot)).numpy(),
                               np.asarray(jvec.rotate(v, rot)), atol=1e-5)


def test_make_camera_matches_jax():
    args = ((1.0, 2.0, 3.0), (0.0, 0.5, -1.0), (0, 1, 0), 35.0, 1.7, 0.3,
            4.0, 0.0, 1.0)
    ref = jax.tree.map(np.asarray, jcam.make_camera(*args))
    got = tcam.make_camera(*args, device="cpu")
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name), atol=1e-6,
                                   err_msg=name)


def test_camera_rays_from_fed_draws_match_jax():
    """JAX draws its jitter, lens disk and shutter times inside
    generate_pixel_rays; the same draws, fed to the port, give the same rays
    (atol 1e-6)."""
    jc = jcam.make_camera((0.2, 0.4, 2.0), (0, 0.2, -3), vfov=45, aspect=2.0,
                          aperture=0.25, focus_dist=5.0, time0=0.0,
                          time1=0.5)
    w, h, spp = 8, 4, 3
    pix = np.random.default_rng(5).permutation(w * h).astype(np.int32)[:20]
    key = jax.random.key(11)
    ref = jcam.generate_pixel_rays(jc, w, h, spp, key, jnp.asarray(pix))
    # generate_pixel_rays' and get_rays' key splits, replayed
    n = pix.shape[0] * spp
    ku, kv, kr = jax.random.split(key, 3)
    jitter = np.stack([np.asarray(jrng.uniform(ku, (n,))),
                       np.asarray(jrng.uniform(kv, (n,)))], -1)
    kd, kt = jax.random.split(kr)
    disk = np.asarray(jrng.random_in_unit_disk(kd, (n,)))
    time_u = np.asarray(jrng.uniform(kt, (n,)))
    tc = camera_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    got = tcam.generate_pixel_rays(tc, w, h, spp, _t(pix), jitter=_t(jitter),
                                   disk=_t(disk), time_u=_t(time_u))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_generate_pixel_rays_draws_from_generator():
    cam = tcam.make_camera((0, 0, 1), (0, 0, -1), aspect=2.0, device="cpu")
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tcam.generate_pixel_rays(cam, 8, 4, 2, generator=g1)
    b = tcam.generate_pixel_rays(cam, 8, 4, 2, generator=g2)
    assert a.origin.shape == (64, 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_rays_point_at_and_make_rays():
    r = make_rays([[0.0, 1.0, 2.0]], [[1.0, 0.0, 0.0]], device="cpu")
    assert r.time.shape == (1,) and float(r.time[0]) == 0.0
    assert r.point_at(torch.tensor([2.0])).tolist() == [[2.0, 1.0, 2.0]]


def _ks_uniform(x: np.ndarray) -> float:
    """Kolmogorov-Smirnov statistic of x against U[0, 1)."""
    x = np.sort(x.astype(np.float64))
    n = x.shape[0]
    return float(max((np.arange(1, n + 1) / n - x).max(),
                     (x - np.arange(n) / n).max()))


@pytest.mark.parametrize("source", ["generator", "counter"])
def test_unit_ball_draws_distribution(source):
    """Both draw paths give uniform points in the unit ball: |p| <= 1, mean
    near 0 (4 sigma at 2^16 samples), r^3 and the extra uniform uniform on
    [0, 1) (KS < 0.01; the 1% critical value at n = 2^16 is 0.0064)."""
    n = 1 << 16
    if source == "generator":
        ball, prob = trng.unit_ball(n, torch.Generator().manual_seed(1))
    else:
        ball, prob = trng.counter_draws(12345, torch.arange(n), 3)
    ball, prob = ball.numpy(), prob.numpy()
    r = np.linalg.norm(ball.astype(np.float64), axis=-1)
    assert r.max() <= 1.0 + 1e-6
    assert np.abs(ball.mean(0)).max() < 4 * 0.45 / np.sqrt(n)
    assert _ks_uniform(r ** 3) < 0.01
    assert _ks_uniform(prob) < 0.01


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors (Random123's kat_vectors)."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for ctr, key, want in cases:
        got = trng.philox4x32(tuple(torch.tensor([c]) for c in ctr), *key)
        assert [int(x) for x in got] == list(want)


def test_counter_draws_depend_on_counter_not_batch():
    """A ray's draws are a function of (seed, index, step) only."""
    idx = torch.arange(100)
    a = trng.counter_uniforms(7, idx, 2)
    b = trng.counter_uniforms(7, idx[40:60], 2)
    assert torch.equal(a[40:60], b)
    assert not torch.equal(a, trng.counter_uniforms(7, idx, 3))
    assert not torch.equal(a, trng.counter_uniforms(8, idx, 2))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_background_sky_matches_jax():
    d, _ = _vecs(6)
    np.testing.assert_allclose(tinteg.background_sky(_t(d)).numpy(),
                               np.asarray(jinteg.background_sky(d)),
                               atol=1e-6)


@pytest.mark.parametrize("wh", [(64, 32), (100, 37), (1920, 1080), (1, 1)])
def test_swizzle_permutation_matches_jax(wh):
    w, h = wh
    ref = np.asarray(jrender._swizzled_pixels(w, h))
    got = trender.swizzled_pixels(w, h).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.array_equal(np.sort(got), np.arange(w * h))


def test_write_png_bytes_match_jax(tmp_path):
    img = np.random.default_rng(7).uniform(size=(9, 13, 3)).astype(
        np.float32)
    for rgba in (True, False):
        pj, pt = tmp_path / f"j{rgba}.png", tmp_path / f"t{rgba}.png"
        jimage.write_png(str(pj), img, rgba=rgba)
        timage.write_png(str(pt), torch.from_numpy(img), rgba=rgba)
        assert pj.read_bytes() == pt.read_bytes()
    assert timage.encode_png(timage.to_rgba_bytes(img)) == \
        jimage.encode_png(jimage.to_rgba_bytes(img))


def test_config_defaults_match_jax():
    from cudaraytracer_tpu import config as jconfig
    assert [f.name for f in dataclasses.fields(tconfig.RenderConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.RenderConfig)]
    assert dataclasses.asdict(tconfig.RenderConfig()) == \
        dataclasses.asdict(jconfig.RenderConfig())
    assert dataclasses.asdict(tconfig.Quirks.fixed()) == \
        dataclasses.asdict(jconfig.Quirks.fixed())


@pytest.mark.parametrize("kw,item", [
    (dict(wavefront_compact=True), "item 22"),
    (dict(grad_sync_axes=("dp", "tp")), "item 20"),
])
def test_config_rejects_unported_knobs(kw, item):
    """Every knob is ported now (ROADMAP items 22 and 20): check_supported
    admits both; render_image runs under wavefront_compact, and under
    grad_sync_axes it asks for the mesh to average over (one made without
    a process group is the identity)."""
    from cudaraytracer_tpu_torch.parallel.mesh import make_mesh
    cfg = tconfig.RenderConfig(width=8, height=4, samples=1, max_depth=2,
                               **kw)
    tconfig.check_supported(cfg)
    scene, cam = tpresets.three_spheres(device="cpu")
    plain = trender.render_image(scene, cam, dataclasses.replace(
        cfg, wavefront_compact=False, grad_sync_axes=()))
    if cfg.grad_sync_axes:
        with pytest.raises(ValueError, match="needs the mesh"):
            trender.render_image(scene, cam, cfg)
        pix = trender.swizzled_pixels(8, 4)
        got = trender.render_pixels(scene, cam, cfg, pix, mesh=make_mesh(1))
        assert torch.equal(got, plain.reshape(-1, 3)[pix])
    else:
        assert torch.equal(trender.render_image(scene, cam, cfg), plain)


@pytest.mark.parametrize("engine", ["mega_diff", "mega"])
def test_config_admits_mega_mxu(engine):
    """cfg.mega_mxu (kernel mode K12) is ported: admitted under both fused
    engines; a scene without streamed triangles renders as without it."""
    cfg = tconfig.RenderConfig(width=8, height=4, samples=1, engine=engine,
                               mega_mxu=True)
    tconfig.check_supported(cfg)
    scene, cam = tpresets.three_spheres(device="cpu")
    got = trender.render_image(scene, cam, cfg,
                               generator=torch.Generator().manual_seed(3))
    want = trender.render_image(scene, cam,
                                dataclasses.replace(cfg, mega_mxu=False),
                                generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(compact_after=2),
    dict(compact_every=2),
    dict(mega_f2b_shells=4),
    dict(compact_every=1, compact_octants=True),
    dict(compact_every=3, compact_auto=False, mega_f2b_shells=8),
])
def test_config_admits_slice5_knobs(kw):
    """The compaction drivers (kernel mode K10) and the front-to-back
    shells (K11) render three_spheres at 8x4x1 on the CPU equal to the
    monolithic render: the draws are keyed by ray id, so the windows and
    the regrouping change no number."""
    base = tconfig.RenderConfig(width=8, height=4, samples=1, max_depth=4,
                                engine="mega")
    cfg = dataclasses.replace(base, **kw)
    tconfig.check_supported(cfg)
    scene, cam = tpresets.three_spheres(device="cpu")
    want = trender.render_image(scene, cam, base,
                                torch.Generator().manual_seed(3))
    got = trender.render_image(scene, cam, cfg,
                               torch.Generator().manual_seed(3))
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_config_accepts_mega():
    tconfig.check_supported(tconfig.RenderConfig(engine="mega"))
    for replay in (True, False):
        tconfig.check_supported(tconfig.RenderConfig(
            engine="mega_diff", mega_replay_bwd=replay))


def test_config_accepts_the_wavefront_and_its_knobs():
    """engine='wavefront' (the default) with each sphere-cull policy, the
    attribute-carrying sweep and either source of draws."""
    for cull in ("morton", "primary", "off"):
        for attrs in (False, True):
            tconfig.check_supported(tconfig.RenderConfig(
                wavefront_sphere_cull=cull, wavefront_kernel_attrs=attrs,
                wavefront_tpu_prng=attrs))
    with pytest.raises(ValueError, match="wavefront_sphere_cull"):
        tconfig.check_supported(tconfig.RenderConfig(
            wavefront_sphere_cull="sometimes"))


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no device given and no card present, entry points raise instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpresets.three_spheres()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcam.make_camera((0, 0, 1), (0, 0, 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SceneBuilder().build()
    from cudaraytracer_tpu_torch.apps import render as app
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--width", "8", "--height", "4", "--spp", "1"])


def test_make_rays_raises_without_a_card(monkeypatch):
    """make_rays of host arrays with no device given goes to the card, so
    it raises where there is none; a tensor keeps its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o = np.zeros((2, 3), np.float32)
    d = np.ones((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_rays(o, d)
    r = make_rays(torch.from_numpy(o), d)
    assert r.origin.device.type == r.direction.device.type == "cpu"
