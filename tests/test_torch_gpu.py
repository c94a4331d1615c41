"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and asks the ``cuda`` fixture for
the device, which skips where there is no card.  This file imports neither
JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest tests/test_torch_gpu.py -m gpu -o addopts="" \
        --noconftest -p no:cacheprovider -q

Tolerance: the kernel is built without FMA contraction, so it rounds like
the plain version; every ray must agree to 1e-5 (kernel against plain), and
the draws to 1e-5.
"""

import dataclasses

import pytest
import torch

from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.models import presets
from cudaraytracer_tpu_torch.ops import megakernel as mk
from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
from cudaraytracer_tpu_torch.ops.render import render_image, swizzled_pixels

DEPTH = 8
ATOL = 1e-5
INTEGRATORS = ("path", "lambert", "normal")


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _scene(name, dev):
    if name == "three_spheres":
        return presets.three_spheres(2.0, device=dev), Quirks.reference()
    if name == "random_spheres":
        return presets.random_spheres(2.0, device=dev), Quirks.reference()
    quirks = Quirks.fixed() if name == "mixed_fixed" else Quirks.reference()
    return cs.mixed_scene(dev), quirks


def _assert_rays_match(got, ref):
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", ["three_spheres", "mixed_reference",
                                  "mixed_fixed", "random_spheres"])
def test_kernel_matches_plain(cuda, name, integrator):
    (scene, cam), quirks = _scene(name, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cfg = RenderConfig(width=64, height=32, samples=4, max_depth=DEPTH,
                       integrator=integrator, quirks=quirks, engine="mega")
    rays = generate_pixel_rays(cam, 64, 32, 4, generator=gen)
    n = rays.origin.shape[0]
    stream = stream_from_generator(gen, n, DEPTH, cuda)
    tables = mk.morton_tables(scene)
    before = mk.LAUNCHES["mega_trace"]
    got = mk.trace_path_mega(scene, rays, cfg, tables=tables, samples=stream)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["mega_trace"] == before + 1
    ref = mk.trace_path_mega_plain(tables, rays, cfg,
                                   mk.stream_tensor(stream, n, DEPTH + 1))
    _assert_rays_match(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("draws", ["injected", "in_kernel"])
@pytest.mark.parametrize("frame", ["random_spheres", "icosphere"])
def test_kernel_matches_plain_on_main_path_chunk(cuda, frame, draws):
    """One full launch of the main path: the first 2^18 rays of a 16:9
    frame in swizzled order; the icosphere (fixed quirks) runs the
    two-level triangle cull."""
    if frame == "icosphere":
        scene, cam = cs.icosphere_scene(16 / 9, device=cuda)
        cfg = RenderConfig(width=1280, height=720, samples=8,
                           max_depth=DEPTH, quirks=Quirks.fixed(),
                           engine="mega")
    else:
        scene, cam = presets.random_spheres(16 / 9, device=cuda)
        cfg = RenderConfig(width=1920, height=1080, samples=16,
                           max_depth=DEPTH, engine="mega")
    gen = torch.Generator(device=cuda).manual_seed(3)
    pix = swizzled_pixels(cfg.width, cfg.height, device=cuda)
    rays = generate_pixel_rays(cam, cfg.width, cfg.height, cfg.samples,
                               pix[:cfg.ray_chunk // cfg.samples],
                               generator=gen)
    n = rays.origin.shape[0]
    assert n == cfg.ray_chunk
    tables = mk.morton_tables(scene)
    if draws == "in_kernel":
        got = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=17)
        _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, cfg,
                                                         None, 17))
        return
    stream = stream_from_generator(gen, n, DEPTH, cuda)
    st = mk.stream_tensor(stream, n, DEPTH + 1)
    for integrator in INTEGRATORS:
        c = dataclasses.replace(cfg, integrator=integrator)
        got = mk.trace_path_mega(scene, rays, c, tables=tables,
                                 samples=stream)
        _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, c, st))


@pytest.mark.gpu
def test_in_kernel_draws_match_plain(cuda):
    (scene, cam), _ = _scene("random_spheres", cuda)
    rays = generate_pixel_rays(
        cam, 64, 32, 4, generator=torch.Generator(device=cuda).manual_seed(2))
    cfg = RenderConfig(width=64, height=32, samples=4, max_depth=DEPTH,
                       engine="mega")
    tables = mk.morton_tables(scene)
    got = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=99)
    _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, cfg, None,
                                                     99))


@pytest.mark.gpu
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_duplicate_prims_first_wins(cuda, integrator):
    scene, cam = cs.duplicate_scene(cuda)
    single, _ = cs.duplicate_scene(cuda, duplicates=False)
    rays = generate_pixel_rays(
        cam, 64, 32, 2, generator=torch.Generator(device=cuda).manual_seed(1))
    cfg = RenderConfig(width=64, height=32, samples=2, max_depth=DEPTH,
                       integrator=integrator, quirks=Quirks.fixed(),
                       engine="mega")
    tables = mk.morton_tables(scene)
    got = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=5)
    ref = mk.trace_path_mega_plain(tables, rays, cfg, None, 5)
    assert float((got - ref).abs().max()) <= 1e-6
    one = mk.trace_path_mega(single, rays, cfg,
                             tables=mk.morton_tables(single), seed=5)
    assert torch.equal(got, one)


@pytest.mark.gpu
def test_scatter_draws_match_plain(cuda):
    n = 1 << 20
    out = mk.scatter_draws(torch.empty(n, 4, device=cuda), 99, 3)
    ref = mk.scatter_draws_plain(n, 99, 3, cuda)
    assert float((out - ref).abs().max()) <= 1e-5
    r = out[:, :3].double().norm(dim=1)
    assert float(r.max()) <= 1.0 + 1e-6
    assert float(out[:, :3].mean(0).abs().max()) < 5e-3


@pytest.mark.gpu
def test_render_image_runs_the_kernel(cuda):
    scene, cam = presets.three_spheres(2.0, device=cuda)
    cfg = RenderConfig(width=64, height=32, samples=2, engine="mega",
                       ray_chunk=1024)
    mk.reset_launch_counts()
    img = render_image(scene, cam, cfg)
    assert mk.LAUNCHES["mega_trace"] == 4
    assert img.is_cuda and torch.isfinite(img).all()


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs(cuda):
    scene, _ = presets.three_spheres(2.0, device=cuda)
    tables = mk.build_mega_tables(scene)
    cfg = RenderConfig(width=8, height=4, samples=1, integrator="normal",
                       engine="mega")
    o = torch.zeros(5, 3, device=cuda)
    with pytest.raises(ValueError):
        mk._launch_mega(tables, o, torch.zeros(5, 3), cfg, None, 0)
    with pytest.raises(ValueError):
        mk._launch_mega(tables, o, torch.zeros(5, 4, device=cuda), cfg,
                        None, 0)


@pytest.mark.gpu
def test_counting_variant_matches_production(cuda):
    """The counting variant renders what the production variant renders,
    and counts tests only where asked."""
    scene, cam = cs.icosphere_scene(2.0, device=cuda)
    rays = generate_pixel_rays(
        cam, 64, 32, 2, generator=torch.Generator(device=cuda).manual_seed(4))
    cfg = RenderConfig(width=64, height=32, samples=2, max_depth=DEPTH,
                       quirks=Quirks.fixed(), engine="mega")
    tables = mk.morton_tables(scene)
    counts = torch.zeros(3, dtype=torch.int64, device=cuda)
    counted = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None,
                              9, counts=counts)
    plain = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None, 9)
    assert torch.equal(counted, plain)
    n_box, n_sph, n_tri = counts.tolist()
    assert n_box > 0 and n_sph > 0 and n_tri > 0
    assert n_sph % 16 == 0 and n_tri % 16 == 0


@pytest.mark.gpu
def test_exact_ties_first_sphere_wins(cuda):
    from cudaraytracer_tpu_torch.core.rays import make_rays
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    scene = cs.fill_tie_scene(SceneBuilder()).build(cuda)
    rays = make_rays(cs.TIE_ORIGINS, cs.TIE_DIRECTIONS, device=cuda)
    cfg = RenderConfig(max_depth=0, quirks=Quirks.fixed(), engine="mega")
    for tables in (mk.build_mega_tables(scene), mk.morton_tables(scene)):
        got = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=0)
        assert torch.equal(got.cpu(), torch.from_numpy(cs.TIE_EXPECTED))
