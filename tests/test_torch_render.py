"""The whole slice: the port's render_image (swizzled screen blocks, chunked
integration, mean over samples, sqrt gamma, clip) against the JAX
render_image, and the port's CLI.

The JAX render_image draws its camera rays and its scatter stream from the key
internally; the test replays those draws and injects them into the port,
so both post-process the same radiance.  Tolerance atol 1e-3 on the
image: the radiance agrees to 2e-4 (test_torch_megakernel), and the sqrt
gamma magnifies an error by 1 / (2 sqrt(x)), at most 5x for the radiance
above 0.01 that these scenes produce.
"""

import jax
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core import camera as jcam
from cudaraytracer_tpu.models import presets as jpresets
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import render as jrender
from cudaraytracer_tpu_torch.apps import render as app
from cudaraytracer_tpu_torch.config import RenderConfig
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.ops import render as trender
from cudaraytracer_tpu_torch.ops.integrators import SampleStream
from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                   scene_from_numpy)
from test_megakernel import _mixed_scene

W, H, SPP, DEPTH = 32, 16, 2, 8


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_image_and_draws(js, jc, cfg, key):
    """JAX's render_image, and the rays and stream it drew inside (one
    chunk: ray_chunk covers the frame)."""
    img = np.asarray(jrender.render_image(js, jc, key, cfg))
    pix = jrender._swizzled_pixels(cfg.width, cfg.height)
    kray, kshade = jax.random.split(jax.random.fold_in(key, 0))
    rays = jcam.generate_pixel_rays(jc, cfg.width, cfg.height, cfg.samples,
                                    kray, pix)
    stream = jinteg.stream_from_key(kshade, rays.origin.shape[0],
                                    cfg.max_depth)
    return img, rays, stream


@pytest.mark.parametrize("integrator", ["path", "lambert", "normal"])
@pytest.mark.parametrize("scene", ["three_spheres", "mixed"])
def test_render_image_matches_jax(scene, integrator):
    js, jc = (jpresets.three_spheres(aspect=2.0) if scene == "three_spheres"
              else _mixed_scene())
    jcfg = JConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                   integrator=integrator, engine="mega")
    ref, jrays, jstream = _jax_image_and_draws(js, jc, jcfg,
                                               jax.random.key(21))
    ts = scene_from_numpy(_np_tree(js), "cpu")
    tc = camera_from_numpy(_np_tree(jc), "cpu")
    cfg = RenderConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                       integrator=integrator, engine="mega")
    got = trender.render_image(
        ts, tc, cfg, rays=Rays(*(_t(x) for x in jrays)),
        samples=SampleStream(_t(jstream.ball), _t(jstream.prob)))
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


def test_chunking_does_not_change_the_image():
    """Under an injected stream, ray_chunk only changes how the work is
    cut: the image is identical."""
    scene, cam = tpresets.three_spheres(aspect=2.0, device="cpu")
    n = W * H * SPP
    rng = np.random.default_rng(0)
    pix = trender.swizzled_pixels(W, H)
    from cudaraytracer_tpu_torch.core import camera as tcam
    rays = tcam.generate_pixel_rays(
        cam, W, H, SPP, pix,
        jitter=_t(rng.uniform(size=(n, 2)).astype(np.float32)),
        disk=torch.zeros(n, 3), time_u=torch.zeros(n))
    g = rng.standard_normal((DEPTH + 1, n, 3))
    ball = g / np.linalg.norm(g, axis=-1, keepdims=True) * rng.uniform(
        size=(DEPTH + 1, n, 1)) ** (1 / 3)
    stream = SampleStream(_t(ball.astype(np.float32)),
                          _t(rng.uniform(size=(DEPTH + 1, n)).astype(
                              np.float32)))
    images = [trender.render_image(
        scene, cam, RenderConfig(width=W, height=H, samples=SPP,
                                 engine="mega", ray_chunk=chunk),
        rays=rays, samples=stream) for chunk in (1 << 18, 96)]
    assert torch.equal(images[0], images[1])


def test_render_draws_from_the_generator():
    scene, cam = tpresets.three_spheres(aspect=2.0, device="cpu")
    cfg = RenderConfig(width=16, height=8, samples=2, engine="mega",
                       ray_chunk=64)
    a = trender.render_image(scene, cam, cfg)
    b = trender.render_image(scene, cam, cfg,
                             generator=torch.Generator().manual_seed(0))
    c = trender.render_image(scene, cam, cfg,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_finish_pixels_mean_gamma_clip():
    x = torch.tensor([[-1.0, 0.0, 0.25], [4.0, 0.0625, 1.0]])
    cfg = RenderConfig(engine="mega")
    assert trender.finish_pixels(x, cfg).tolist() == \
        [[0.0, 0.0, 0.5], [1.0, 0.25, 1.0]]
    raw = RenderConfig(engine="mega", clip=False, gamma=False)
    assert torch.equal(trender.finish_pixels(x, raw), x)


def test_render_pixels_subset_matches_full_image():
    """Rendering a subset of pixels gives those pixels of the full frame
    (normal integrator, rays injected at the pixel centres)."""
    from cudaraytracer_tpu_torch.core import camera as tcam
    scene, cam = tpresets.three_spheres(aspect=2.0, device="cpu")
    cfg = RenderConfig(width=16, height=8, samples=1, engine="mega",
                       integrator="normal")

    def centre_rays(pix):
        n = pix.shape[0]
        return tcam.generate_pixel_rays(cam, 16, 8, 1, pix,
                                        jitter=torch.full((n, 2), 0.5),
                                        disk=torch.zeros(n, 3),
                                        time_u=torch.zeros(n))

    every = torch.arange(128)
    full = trender.render_pixels(scene, cam, cfg, every,
                                 rays=centre_rays(every))
    pix = torch.tensor([0, 5, 77, 127])
    part = trender.render_pixels(scene, cam, cfg, pix, rays=centre_rays(pix))
    assert torch.equal(part, full[pix])


@pytest.mark.parametrize("argv", [
    ["--scene", "three_spheres"],
    ["--scene", "random_spheres", "--integrator", "lambert"],
    ["--integrator", "normal", "--quirks", "fixed", "--accel", "mega"],
])
def test_cli_renders_png_on_cpu(tmp_path, argv, capsys):
    out = tmp_path / "img.png"
    assert app.main(["--cpu", "--width", "16", "--height", "8", "--spp",
                     "1", "--out", str(out)] + argv) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "mega on cpu" in capsys.readouterr().out


def test_cli_renders_obj(tmp_path):
    obj = tmp_path / "tet.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                   "f 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n")
    out = tmp_path / "obj.png"
    assert app.main(["--cpu", "--obj", str(obj), "--width", "16",
                     "--height", "16", "--spp", "1", "--out", str(out),
                     "--quirks", "fixed"]) == 0
    assert out.exists()


@pytest.mark.parametrize("argv,err", [
    (["--compact-after", "2"], "item 19"),
    (["--scene", "light_box"], "slice 5"),
])
def test_cli_rejects_unported(tmp_path, argv, err):
    with pytest.raises(NotImplementedError, match=err):
        app.main(["--cpu", "--width", "8", "--height", "4", "--spp", "1",
                  "--out", str(tmp_path / "x.png")] + argv)


def test_jax_scene_renders_through_port_entry():
    """A scene made by the JAX SceneBuilder renders through the port after
    conversion, with the port's own draws."""
    js, jc = _mixed_scene()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    tc = camera_from_numpy(_np_tree(jc), "cpu")
    img = trender.render_image(ts, tc, RenderConfig(
        width=16, height=8, samples=2, engine="mega"))
    assert img.shape == (8, 16, 3) and torch.isfinite(img).all()
