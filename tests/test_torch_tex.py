"""Image textures in the port against the JAX package on the CPU: the texel
lookup (``models/textures.py``, ``models/materials.py``), the wavefront
integrators on image scenes, the fused engine's plain version of kernel
mode K9 (``ops/megakernel.py``), the mega_diff gradients, the presets, the
engine routing and the PNG reader.

Scenes are built by the JAX SceneBuilder (tests/test_mega_tex.py's image
scene, the presets) and carried across with ``scene_from_numpy``; rays come
from numpy jitter through the port's camera, and the scatter stream from
numpy, injected into both packages.

Tolerances:
  * texel lookups, presets, PNG decoding: exact (bytes / 255 correctly
    rounded on both sides, as JAX computes it outside jit);
  * wavefront radiance: atol 2e-4, rtol 1e-4 on every ray, the band of
    tests/test_torch_wavefront.py (XLA contracts a * b + c into FMAs on the
    CPU and PyTorch does not);
  * the fused plain version against JAX ``trace_path_mega_tex`` (its
    ``_mega_kernel`` in interpret mode, then the deferred texture pass) and
    against the JAX wavefront: the same band, except that at most 0.5% of
    rays may exceed it, where the FMA difference (or, against JAX's fused
    Gram-solve uv, the uv formula) moves a (u, v) across a texel edge or
    flips a grazing hit; the count is printed by the assertion;
  * mega_diff gradients against ``jax.grad`` through the JAX wavefront on
    the same stream: 1e-3 of the largest entry of each parameter.
"""

import dataclasses
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import Quirks as JQuirks
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core import camera as jcam
from cudaraytracer_tpu.core.rays import Rays as JRays
from cudaraytracer_tpu.models import materials as jmat
from cudaraytracer_tpu.models import presets as jpresets
from cudaraytracer_tpu.models import textures as jtex
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import megakernel as jmk
from cudaraytracer_tpu.utils import image as jimage
from cudaraytracer_tpu_torch.apps import render as render_app
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core import camera as tcam
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.models import materials as tmat
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.models import textures as ttex
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.ops import render as trender
from cudaraytracer_tpu_torch.ops.integrators import SampleStream
from cudaraytracer_tpu_torch.utils import image as timage
from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                   scene_from_numpy, to_numpy)
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_mega_tex import _image_scene

W, H, SPP, DEPTH = 32, 16, 1, 4
ATOL, RTOL = 2e-4, 1e-4


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _tq(q):
    return Quirks(**q.__dict__)


def _inputs(jc, seed, w=W, h=H, spp=SPP, depth=DEPTH):
    """(numpy rays through the port's camera, numpy ball and prob)."""
    rng = np.random.default_rng(seed)
    n = w * h * spp
    rays = tcam.generate_pixel_rays(
        camera_from_numpy(_np_tree(jc), "cpu"), w, h, spp,
        jitter=torch.from_numpy(rng.uniform(size=(n, 2)).astype(np.float32)),
        disk=torch.zeros(n, 3), time_u=torch.zeros(n))
    g = rng.standard_normal((depth + 1, n, 3))
    r = rng.uniform(size=(depth + 1, n, 1)) ** (1.0 / 3.0)
    ball = (g / np.linalg.norm(g, axis=-1, keepdims=True) * r)
    prob = rng.uniform(size=(depth + 1, n))
    return (tuple(x.numpy() for x in rays), ball.astype(np.float32),
            prob.astype(np.float32))


def _both(rays_np, ball, prob):
    o, d, t = rays_np
    return ((JRays(*map(jnp.asarray, (o, d, t))),
             jinteg.SampleStream(jnp.asarray(ball), jnp.asarray(prob))),
            (Rays(*map(torch.from_numpy, (o, d, t))),
             SampleStream(torch.from_numpy(ball), torch.from_numpy(prob))))


def _cfgs(integrator="path", quirks=None, engine="mega", **kw):
    quirks = quirks or JQuirks.reference()
    jcfg = JConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                   integrator=integrator, quirks=quirks, **kw)
    tcfg = RenderConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                        integrator=integrator, quirks=_tq(quirks),
                        engine=engine, **kw)
    return jcfg, tcfg


def _assert_radiance(got, ref, share=0.0):
    assert np.isfinite(got).all()
    over = np.abs(got - ref) > ATOL + RTOL * np.abs(ref)
    bad = int(over.any(axis=1).sum())
    assert bad <= share * got.shape[0], (bad, float(np.abs(got - ref).max()))


def _image_textures(builder):
    """A constant, a checker and two images of different sizes (5x7 and
    9x3, so the padded table is 9x7) -> the texture ids."""
    rng = np.random.default_rng(11)
    return [builder.constant((0.1, 0.2, 0.3)),
            builder.checker((0.9, 0.8, 0.7), (0.0, 0.1, 0.2)),
            builder.image(rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)),
            builder.image(rng.integers(0, 256, (9, 3, 3), dtype=np.uint8))]


def _lookup_inputs(n=512):
    """Texture ids over all four kinds; (u, v) outside [0, 1], on texel
    edges, infinite and NaN; hit points for the checker."""
    rng = np.random.default_rng(12)
    tid = rng.integers(0, 4, n).astype(np.int32)
    u = rng.uniform(-0.5, 1.5, n).astype(np.float32)
    v = rng.uniform(-0.5, 1.5, n).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, 1.0, 1 / 7, 2 / 3,
                        -0.0, 3e9, -3e9], np.float32)
    u[:special.size] = special
    v[special.size:2 * special.size] = special
    u[2 * special.size:3 * special.size] = special[::-1]
    v[2 * special.size:3 * special.size] = special
    p = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    return tid, u, v, p


# ---------------------------------------------------------------------------
# (i) The texel lookup
# ---------------------------------------------------------------------------

def test_texel_lookup_matches_jax_exactly():
    """eval_texture, image_texel and the decoded-row form against JAX, two
    images of different sizes in one padded table."""
    jb, tb = jtex.TextureBuilder(), ttex.TextureBuilder()
    _image_textures(jb)
    _image_textures(tb)
    jt, tt = jb.build(), tb.build("cpu")
    assert tuple(tt.images.shape) == (3, 9, 7, 3)
    tid, u, v, p = _lookup_inputs()
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    ref = np.asarray(jtex.eval_texture(jt, tid, u, v, p))
    got = ttex.eval_texture(tt, torch.from_numpy(tid), tu, tv,
                            torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), ref)
    img = tid >= 2
    ref_img = np.asarray(jtex.image_texel(jt, tid[img], u[img], v[img]))
    got_img = ttex.image_texel(tt, torch.from_numpy(tid[img]), tu[img],
                               tv[img])
    np.testing.assert_array_equal(got_img.numpy(), ref_img)
    # every texel of both images is reachable: the lookup is not stuck
    assert len({tuple(x) for x in ref_img.tolist()}) > 20
    # the decoded-row form (the wavefront's) on the same lookups
    jm, tm = jmat.MaterialBuilder(jb), tmat.MaterialBuilder(tb)
    for mb in (jm, tm):
        for k in range(4):
            mb.lambertian(tex_id=k)
    jmt, tmt = jm.build(), tm.build("cpu")
    jdec = jmat.decode_materials(jmt, jt, jnp.asarray(tid))
    tdec = tmat.decode_materials(tmt, tt, torch.from_numpy(tid))
    ref_dec = np.asarray(jmat.eval_texture_dec(jdec, jt, u, v, p))
    got_dec = tmat.eval_texture_dec(tdec, tt, tu, tv, torch.from_numpy(p))
    np.testing.assert_array_equal(got_dec.numpy(), ref_dec)
    np.testing.assert_array_equal(got_dec.numpy(), ref)


# ---------------------------------------------------------------------------
# (ii) The wavefront
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["path", "lambert"])
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_wavefront_image_scene_matches_jax(profile, integrator):
    """trace_path and lambert_shade (brute force) on tests/test_mega_tex.py's
    image scene: an image lambertian, an image light on a rect, every other
    material."""
    js, jc = _image_scene()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    jcfg, tcfg = _cfgs(integrator, getattr(JQuirks, profile)(),
                       engine="wavefront")
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 1))
    if integrator == "path":
        ref = jinteg.trace_path(js, jr, jax.random.key(0), jcfg,
                                samples=jst)
        with torch.no_grad():
            got = tinteg.trace_path(ts, tr, tcfg, samples=tst)
    else:
        ref = jinteg.lambert_shade(js, jr, jax.random.key(0), jcfg)
        got = tinteg.lambert_shade(ts, tr, tcfg)
    ref = np.asarray(ref)
    assert ref.max() > 0.3           # the image light is in view
    _assert_radiance(got.numpy(), ref)


# ---------------------------------------------------------------------------
# (iii) The fused engine (K9's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [("path", "reference"), ("path", "fixed"),
                                  ("lambert", "reference")])
def test_fused_image_scene_matches_jax_mega_tex(case):
    """The fused plain version against JAX trace_path_mega_tex on the same
    Morton tables and stream: the path under both quirk profiles, lambert
    (whose att term also multiplies the image light)."""
    integrator, profile = case
    js, jc = _image_scene()
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    jcfg, tcfg = _cfgs(integrator, getattr(JQuirks, profile)())
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 2))
    orders = tmk.mega_orders(tree)
    jt = jmk.build_mega_tables(js, tri_order=orders[0], sph_order=orders[1])
    ref = np.asarray(jmk.trace_path_mega_tex(js, jr, jax.random.key(0), jcfg,
                                             samples=jst, tables=jt))
    got = tmk.trace_path_mega(ts, tr, tcfg,
                              tables=tmk.build_mega_tables(ts, *orders),
                              samples=tst).numpy()
    assert ref.max() > 0.3
    _assert_radiance(got, ref, share=0.005)


def _trs_image_scene():
    """Runtime-TRS prims on images: a TRS sphere and a TRS triangle, each
    on an image lambertian, an image rect light, a plain ground sphere."""
    b = JSceneBuilder()
    m = b.materials
    rng = np.random.default_rng(5)
    lam = m.lambertian(tex_id=m.textures.image(
        rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)))
    glow = m.diffuse_light(tex_id=m.textures.image(
        rng.integers(100, 256, (4, 4, 3), dtype=np.uint8)))
    b.add_sphere((0, -100.5, -3), 100.0, m.lambertian(color=(.6, .6, .6)))
    b.add_sphere((0, 0, -3), 0.9, lam, rotation=(0, 30, 20),
                 scale=(1.0, 1.4, 1.0))
    b.add_triangle((-1.2, -0.5, 0), (1.2, -0.5, 0), (0, 1.0, 0), lam,
                   position=(1.6, 0.2, -3.5), rotation=(0, -25, 0))
    b.add_rect(glow, position=(0, 2.2, -3), rotation=(90, 0, 0),
               scale=(3, 3, 1))
    cam = jcam.make_camera((0, 0.3, 1), (0, 0, -3), vfov=55, aspect=2.0,
                           focus_dist=4.0)
    return b.build(), cam


def _tex_icosphere():
    return (cs.fill_tex_icosphere_scene(JSceneBuilder()).build(),
            jcam.make_camera((0, 1.6, 4.5), (0, 0.9, 0), (0, 1, 0), 40.0,
                             2.0, 0.0, 10.0))


@pytest.mark.parametrize("scene,integrator,profile", [
    ("trs", "path", "fixed"), ("trs", "lambert", "reference"),
    ("tex_icosphere", "path", "fixed"), ("image", "normal", "reference")])
def test_fused_matches_jax_wavefront(scene, integrator, profile):
    """The fused plain version against the JAX wavefront (its uv are
    finalize_hits', as the port's): TRS prims on images, the textured
    icosphere (whose uv the JAX fused engine solves as a Gram system
    instead) and the normal integrator on the image scene."""
    js, jc = {"trs": _trs_image_scene, "tex_icosphere": _tex_icosphere,
              "image": _image_scene}[scene]()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    jcfg, tcfg = _cfgs(integrator, getattr(JQuirks, profile)())
    jcfg = dataclasses.replace(jcfg, engine="wavefront")
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 3))
    ref = np.asarray(jinteg.integrate(js, jr, jax.random.key(0), jcfg,
                                      samples=jst))
    got = tmk.trace_path_mega(ts, tr, tcfg, tables=tmk.morton_tables(ts),
                              samples=tst).numpy()
    assert ref.std() > 0.05
    _assert_radiance(got, ref, share=0.005)


def test_fused_reads_the_image_at_the_right_texel():
    """The zero-uv quirk reads texel (0, 0), i = 0, j = h - 1: an image
    lambertian renders as a constant one of that texel under the reference
    quirks, and differently under Quirks.fixed()."""
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    texel00 = img[3, 0].astype(np.float32) / np.float32(255)

    def build(use_image):
        b = JSceneBuilder()
        m = b.materials
        if use_image:
            mat = m.lambertian(tex_id=m.textures.image(img))
        else:
            mat = m.lambertian(color=tuple(texel00))
            m.textures.image(img)
        b.add_sphere((0, -100.5, -3), 100.0, m.lambertian(color=(.6, .6, .6)))
        b.add_sphere((0, 0, -3), 1.0, mat)
        return scene_from_numpy(_np_tree(b.build()), "cpu")

    _, jc = _image_scene()
    _, (tr, tst) = _both(*_inputs(jc, 4))
    out = {}
    for profile in ("reference", "fixed"):
        _, tcfg = _cfgs("path", getattr(JQuirks, profile)())
        out[profile] = [tmk.trace_path_mega(s, tr, tcfg, samples=tst)
                        for s in (build(True), build(False))]
    np.testing.assert_allclose(out["reference"][0], out["reference"][1],
                               atol=1e-6)
    assert float((out["fixed"][0] - out["fixed"][1]).abs().max()) > 0.05


# ---------------------------------------------------------------------------
# (iv) mega_diff gradients
# ---------------------------------------------------------------------------

def test_mega_diff_gradients_on_images_match_jax():
    """Albedo (texture color0) and centre gradients of engine='mega_diff'
    (the plain fused forward recording winners, the replay backward that
    evaluates the images at the replayed hits) against jax.grad through the
    JAX wavefront on the same stream."""
    js, jc = _image_scene()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    jcfg, tcfg = _cfgs("path", JQuirks.fixed(), engine="mega_diff")
    jcfg = dataclasses.replace(jcfg, engine="wavefront")
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 5))

    def jloss(centers, c0):
        sc = js._replace(spheres=js.spheres._replace(center=centers),
                         textures=js.textures._replace(color0=c0))
        img = jinteg.trace_path(sc, jr, jax.random.key(0), jcfg, samples=jst)
        return jnp.mean(img ** 2)

    g_ref = jax.grad(jloss, argnums=(0, 1))(js.spheres.center,
                                            js.textures.color0)
    centers = ts.spheres.center.clone().requires_grad_()
    c0 = ts.textures.color0.clone().requires_grad_()
    sc = ts._replace(spheres=ts.spheres._replace(center=centers),
                     textures=ts.textures._replace(color0=c0))
    img = tmk.trace_path_mega_diff(sc, tr, tcfg,
                                   tables=tmk.morton_tables(sc), samples=tst)
    torch.mean(img ** 2).backward()
    for got, ref in ((centers.grad, g_ref[0]), (c0.grad, g_ref[1])):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0.0
        assert np.abs(got.numpy() - ref).max() <= 1e-3 * scale


def test_replay_misses_counts_rays_off_the_recorded_path():
    """replay_misses (ROADMAP Queue 3's measurement): 0 when the replay
    follows the recording's own rays and draws, and nonzero when the rays
    are moved after recording."""
    ts, tc = tpresets.textured_globe(aspect=2.0, device="cpu")
    cfg = RenderConfig(width=W, height=H, samples=2, max_depth=DEPTH,
                       engine="mega")
    rays = tcam.generate_pixel_rays(tc, W, H, 2,
                                    generator=torch.Generator().manual_seed(1))
    _, win = tmk.trace_path_mega(ts, rays, cfg, seed=9, want_winners=True)
    wcfg = dataclasses.replace(cfg, engine="wavefront")
    assert int(tinteg.replay_misses(ts, rays, wcfg, win, seed=9).sum()) == 0
    moved = Rays(rays.origin + torch.tensor([0.3, 0.0, 0.0]), rays.direction,
                 rays.time)
    assert int(tinteg.replay_misses(ts, moved, wcfg, win, seed=9).sum()) > 0


# ---------------------------------------------------------------------------
# (v) Presets, (vi) routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["textured_globe", "random_spheres",
                                  "tex_icosphere"])
def test_image_scenes_match_jax(name):
    """The port's textured_globe, random_spheres(textured=True) and
    tex_icosphere equal the JAX-built scenes carried across."""
    if name == "textured_globe":
        js, jc = jpresets.textured_globe(aspect=2.0)
        ts, tc = tpresets.textured_globe(aspect=2.0, device="cpu")
    elif name == "random_spheres":
        js, jc = jpresets.random_spheres(aspect=2.0, textured=True)
        ts, tc = tpresets.random_spheres(aspect=2.0, textured=True,
                                         device="cpu")
    else:
        js, jc = _tex_icosphere()
        ts, tc = cs.tex_icosphere_scene(2.0, device="cpu")
    ref = scene_from_numpy(_np_tree(js), "cpu")
    for got, want in zip(jax.tree.leaves(_np_tree(to_numpy(ts))),
                         jax.tree.leaves(_np_tree(to_numpy(ref)))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for a, b in zip(tc, _np_tree(jc)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-6)
    assert ts.textures.images.shape[0] > 1
    assert tmk.megakernel_supported(ts)


@pytest.mark.parametrize("engine", ["mega", "mega_diff"])
def test_integrate_routes_image_scenes_as_jax(engine, monkeypatch):
    """Under engine='mega' every integrator goes to the fused kernel; under
    engine='mega_diff' the path goes to trace_path_mega_diff and lambert
    and normal to the wavefront (JAX integrate, integrators.py:399-441,
    sends the same scenes to its fused engines: the deferred pass for path
    and lambert, the plain kernel for normal)."""
    js, jc = _image_scene()
    assert not jmk.megakernel_supported(js) and jmk.mega_tex_supported(js)
    ts = scene_from_numpy(_np_tree(js), "cpu")
    _, (tr, tst) = _both(*_inputs(jc, 6, 8, 4, 1))
    calls = []
    for name in ("trace_path_mega", "trace_path_mega_diff"):
        real = getattr(tmk, name)
        monkeypatch.setattr(tmk, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    for integrator in ("path", "lambert", "normal"):
        calls.clear()
        cfg = RenderConfig(width=8, height=4, samples=1, max_depth=DEPTH,
                           integrator=integrator, engine=engine)
        out = tinteg.integrate(ts, tr, cfg, samples=tst)
        assert out.shape == (32, 3) and bool(torch.isfinite(out).all())
        if engine == "mega":
            assert calls[:1] == ["trace_path_mega"], (integrator, calls)
        elif integrator == "path":
            assert calls[:1] == ["trace_path_mega_diff"], calls
        else:
            assert calls == [], (integrator, calls)


@pytest.mark.parametrize("engine", ["wavefront", "mega", "mega_diff"])
def test_render_image_takes_every_image_scene(engine):
    """No engine raises on images: render_image renders textured_globe,
    random_spheres(textured=True) and tex_icosphere (mega_diff with a
    gradient reaching the sphere centres)."""
    scenes = [tpresets.textured_globe(2.0, device="cpu"),
              tpresets.random_spheres(2.0, textured=True, device="cpu"),
              cs.tex_icosphere_scene(2.0, device="cpu")]
    cfg = RenderConfig(width=8, height=4, samples=1, max_depth=3,
                       engine=engine)
    for scene, cam in scenes:
        centers = scene.spheres.center.clone().requires_grad_()
        scene = scene._replace(spheres=scene.spheres._replace(
            center=centers))
        img = trender.render_image(scene, cam, cfg)
        assert img.shape == (4, 8, 3) and bool(torch.isfinite(img).all())
        if engine == "mega_diff":
            img.sum().backward()
            assert bool(torch.isfinite(centers.grad).all())


@pytest.mark.parametrize("argv", [["--scene", "textured_globe"],
                                  ["--scene", "tex_icosphere"],
                                  ["--scene", "random_spheres",
                                   "--textured"]])
def test_cli_renders_image_scenes(tmp_path, capsys, argv):
    out = tmp_path / "x.png"
    assert render_app.main(["--cpu", "--width", "8", "--height", "4",
                            "--spp", "1", "--max-depth", "2", "--out",
                            str(out)] + argv) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "mega on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (vii) The PNG reader
# ---------------------------------------------------------------------------

def _png(w, h, color_type, depth, rows, plte=None, interlace=0):
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                      0, 0, interlace))
    if plte is not None:
        body += chunk(b"PLTE", plte.tobytes())
    return (b"\x89PNG\r\n\x1a\n" + body
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _random_scanlines(rng, w, h, bpp):
    """Scanlines with random filter types 0-4 and random bytes: every
    such stream decodes, so both readers must agree on it."""
    rows = []
    for _ in range(h):
        rows.append(bytes([int(rng.integers(0, 5))])
                    + rng.integers(0, 256, w * bpp, dtype=np.uint8).tobytes())
    return b"".join(rows)


def _adam7_scanlines(rng, w, h, bpp):
    out = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:
            out += _random_scanlines(rng, pw, ph, bpp)
    return out


def test_read_png_matches_jax(tmp_path):
    """The port's read_png against JAX's on the writer's own RGBA output,
    and on random streams over every filter type: RGB, RGBA, grey, grey +
    alpha, palette, 16-bit, Adam7; and image_from_png builds the same
    texture."""
    rng = np.random.default_rng(13)
    files = []
    pix = rng.uniform(size=(6, 9, 3)).astype(np.float32)
    timage.write_png(str(tmp_path / "w.png"), pix)
    files.append(tmp_path / "w.png")
    w, h = 11, 7
    cases = [(2, 8, 3, None), (6, 8, 4, None), (0, 8, 1, None),
             (4, 8, 2, None), (2, 16, 6, None),
             (3, 8, 1, rng.integers(0, 256, (256, 3), dtype=np.uint8))]
    for k, (ct, depth, bpp, plte) in enumerate(cases):
        for interlace in (0, 1):
            make = _adam7_scanlines if interlace else _random_scanlines
            path = tmp_path / f"c{k}_{interlace}.png"
            path.write_bytes(_png(w, h, ct, depth, make(rng, w, h, bpp),
                                  plte, interlace))
            files.append(path)
    for path in files:
        got, ref = timage.read_png(str(path)), jimage.read_png(str(path))
        assert got.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    back = timage.read_png(str(files[0]))
    np.testing.assert_array_equal(back, timage.to_rgba_bytes(pix))
    jb, tb = jtex.TextureBuilder(), ttex.TextureBuilder()
    assert jb.image_from_png(str(files[1])) == tb.image_from_png(
        str(files[1])) == 0
    np.testing.assert_array_equal(tb.build("cpu").images.numpy(),
                                  np.asarray(jb.build().images))
