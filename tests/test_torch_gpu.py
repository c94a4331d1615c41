"""The CUDA kernels against their plain PyTorch versions, on the card:
the fused kernel K1, its rect / TRS mode K8, winner mode K7, image texture
mode K9, segment level K6, windows K10 (the path state's planes in place,
the regrouping keys, the drivers without a host sync), shells K11 and
bilinear triangle sweep K12 (K6, K11 and K12 by the cooperative sweeps,
held also against the one-thread-per-ray sweep), the path integrator's
persistent warps that refill finished lanes (K1, K7, K8 and K9 at 1 to
2^18 + 7 rays, one and two sphere box levels), the draws K2
(csrc/megakernel*.cu), the sweeps K3, K4 and K5 (csrc/sweeps.cu), the
boxes' margins on rays that stress them (box planes, slivers, tangents to
spheres), K8's culled walk on its edge rays and its counts against its
plain walk, the BVH traversal crt_bvh_traverse (csrc/bvh.cu) in each of
its instances and the refit on the card, the winner sum crt_winner_add
(csrc/sweeps.cu) in both forms, and the wavefront render, the fit, the
mega_diff fit and apps/animate.py through them.

Every test here carries the ``gpu`` marker and asks the ``cuda`` fixture for
the device, which skips where there is no card.  This file imports neither
JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest tests/test_torch_gpu.py -m gpu -o addopts="" \
        --noconftest -p no:cacheprovider -q

Tolerance: the kernels are built without FMA contraction, so they round
like the plain versions; every ray must agree to 1e-5 (kernel against
plain), the draws to 1e-5, and the sweeps' idx exactly.  K9 allows the rays
whose texel flipped at an edge (its atan2f / asinf against PyTorch's,
within rounding of a texel boundary), at most max(2, n / 10^4) of them.
The fused engine against the wavefront on one injected stream: at most
max(2, n / 200) rays over 1e-3.  The winner sum crt_winner_add against
its plain version: each sum to 1e-5 of the |values| added into it (both
sum in other orders, with atomics).  A fit step on the card against the
CPU: the loss to rtol 1e-5 and each gradient to 1e-3 of its largest entry
(the card sums the winner sums with atomics and the means in another
order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.models import mesh as tmesh
from cudaraytracer_tpu_torch.models import presets
from cudaraytracer_tpu_torch.ops import bone_bvh as bb
from cudaraytracer_tpu_torch.ops import bvh as bvhmod
from cudaraytracer_tpu_torch.ops import integrators as integ
from cudaraytracer_tpu_torch.ops import intersect as isect
from cudaraytracer_tpu_torch.ops import megakernel as mk
from cudaraytracer_tpu_torch.ops import sweeps as sw
from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
from cudaraytracer_tpu_torch.ops.render import (render_image, render_pixels,
                                                sweep_intersector,
                                                sweep_intersector_pair,
                                                swizzled_pixels)
from cudaraytracer_tpu_torch.parallel import train

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
    """K2 on one bounce of 2^20 rays, and over a range of bounces in one
    launch (a depth-8 trace's 9 x 2^18 draws from bounce 0, and 4 bounces
    from bounce 5): bit-equal to the plain version and to the one-bounce
    launches stacked."""
    n = 1 << 20
    out = mk.scatter_draws(torch.empty(n, 4, device=cuda), 99, 3)
    ref = mk.scatter_draws_plain(n, 99, 3, cuda)
    assert float((out - ref).abs().max()) <= 1e-5
    r = out[:, :3].double().norm(dim=1)
    assert float(r.max()) <= 1.0 + 1e-6
    assert float(out[:, :3].mean(0).abs().max()) < 5e-3
    n = 1 << 18
    for lo, steps in ((0, DEPTH + 1), (5, 4)):
        before = mk.LAUNCHES["scatter_draws"]
        out = mk.scatter_draws(torch.empty(steps, n, 4, device=cuda), 99, lo)
        assert mk.LAUNCHES["scatter_draws"] == before + 1
        assert torch.equal(out, mk.scatter_draws_plain(n, 99, lo, cuda,
                                                       steps))
        one = torch.stack([mk.scatter_draws(torch.empty(n, 4, device=cuda),
                                            99, s)
                           for s in range(lo, lo + steps)])
        assert torch.equal(out, one)


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
    counts = torch.zeros(mk.N_COUNTS, dtype=torch.int64, device=cuda)
    counted = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None,
                              9, counts=counts)
    plain = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None, 9)
    assert torch.equal(counted, plain)
    n_box, n_sph, n_tri, n_rect, n_tsph, n_ttri, n_seg, n_dist, n_xbox = \
        counts.tolist()
    assert n_box > 0 and n_sph > 0 and n_tri > 0
    assert n_sph % 16 == 0 and n_tri % 16 == 0
    assert n_rect == n_tsph == n_ttri == n_seg == n_dist == n_xbox == 0
    # K8's counting variant below XFORM_CULL_MIN rows a class (the flat
    # walk): every rect / TRS row once per ray and bounce, no chunk test
    scene, cam = cs.trs_showcase_scene(2.0, device=cuda)
    tables = mk.morton_tables(scene)
    counts.zero_()
    counted = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None,
                              9, counts=counts)
    plain = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None, 9)
    assert torch.equal(counted, plain)
    n_rect, n_tsph, n_ttri = counts.tolist()[3:6]
    assert n_rect > 0 and n_tsph == 2 * n_rect and n_ttri == n_rect
    assert counts.tolist()[8] == 0


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


# ---------------------------------------------------------------------------
# Kernel modes K8 (rects, runtime-TRS prims) and K7 (winners)
# ---------------------------------------------------------------------------

def _frame(name, dev):
    """(scene, camera, cfg) of a full-size rect / TRS frame."""
    if name == "light_box":
        scene, cam = presets.light_box(16 / 9, device=dev)
        cfg = RenderConfig(width=1280, height=720, samples=16,
                           max_depth=DEPTH, engine="mega")
    elif name == "showcase":
        scene, cam = cs.trs_showcase_scene(16 / 9, device=dev)
        cfg = RenderConfig(width=1280, height=720, samples=16,
                           max_depth=DEPTH, quirks=Quirks.fixed(),
                           engine="mega")
    else:
        scene, cam = presets.random_spheres(16 / 9, device=dev)
        cfg = RenderConfig(width=1920, height=1080, samples=16,
                           max_depth=DEPTH, engine="mega")
    return scene, cam, cfg


def _first_launch(cam, cfg, dev, seed, index=0):
    pix = swizzled_pixels(cfg.width, cfg.height, device=dev)
    per = cfg.ray_chunk // cfg.samples
    return generate_pixel_rays(
        cam, cfg.width, cfg.height, cfg.samples,
        pix[index * per:(index + 1) * per],
        generator=torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["light_box", "showcase"])
def test_xform_kernel_matches_plain_on_a_full_launch(cuda, frame):
    """K8: the first 2^18 rays of a 1280x720x16 rect / TRS frame, the three
    integrators on an injected stream and the path on in-kernel draws."""
    scene, cam, cfg = _frame(frame, cuda)
    rays = _first_launch(cam, cfg, cuda, 5)
    n = rays.origin.shape[0]
    assert n == cfg.ray_chunk
    tables = mk.morton_tables(scene)
    stream = stream_from_generator(torch.Generator(device=cuda).manual_seed(6),
                                   n, DEPTH, cuda)
    st = mk.stream_tensor(stream, n, DEPTH + 1)
    mk.reset_launch_counts()
    for integrator in INTEGRATORS:
        c = dataclasses.replace(cfg, integrator=integrator)
        got = mk.trace_path_mega(scene, rays, c, tables=tables,
                                 samples=stream)
        _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, c, st))
    got = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=8)
    _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, cfg, None,
                                                     8))
    assert mk.LAUNCHES["mega_trace_xform"] == 4
    assert mk.LAUNCHES["mega_trace"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["random_spheres", "showcase"])
def test_winners_match_plain(cuda, frame):
    """K7: the winners of one full 2^18-ray launch equal the plain
    version's on every ray and bounce, and recording them leaves the
    radiance as the plain launch gives it."""
    scene, cam, cfg = _frame(frame, cuda)
    rays = _first_launch(cam, cfg, cuda, 7)
    tables = mk.morton_tables(scene)
    got, win = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=21,
                                  want_winners=True)
    plain = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=21)
    ref, wref = mk.trace_path_mega_plain(tables, rays, cfg, None, 21,
                                         want_winners=True)
    assert torch.equal(got, plain)
    _assert_rays_match(got, ref)
    assert win.shape == (DEPTH + 1, rays.origin.shape[0])
    assert torch.equal(win, wref)
    n_ids = (scene.n_spheres + scene.n_triangles + scene.n_rects
             + scene.n_t_spheres + scene.n_t_triangles)
    assert int(win.min()) == -1 and int(win.max()) < n_ids


@pytest.mark.gpu
def test_above_cap_trs_scene_matches_plain(cuda):
    """1,100 each of rects, TRS spheres and TRS triangles, above the JAX
    engine's 1024-per-class cap: radiance and winners against the plain
    version."""
    scene, cam = cs.trs_field_scene(1100, 2.0, device=cuda)
    cfg = RenderConfig(width=128, height=64, samples=2, max_depth=4,
                       quirks=Quirks.fixed(), engine="mega")
    rays = generate_pixel_rays(
        cam, 128, 64, 2, generator=torch.Generator(device=cuda).manual_seed(9))
    tables = mk.morton_tables(scene)
    got, win = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=4,
                                  want_winners=True)
    ref, wref = mk.trace_path_mega_plain(tables, rays, cfg, None, 4,
                                         want_winners=True)
    _assert_rays_match(got, ref)
    assert torch.equal(win, wref)
    assert int(win.max()) > scene.n_spheres + 2 * 1100


@pytest.mark.gpu
def test_mega_diff_fit_step_on_the_card_matches_the_cpu(cuda):
    """One mega_diff fit step (K7 forward, replay backward) at 64x32x2 on
    one injected stream: the loss and the gradients on the card against
    the plain CPU run.  Then the seed route on the card: the kernel's
    in-kernel draws in the forward and K2's in the replay give the
    gradients of injecting K2's numbers."""
    w, h, spp, depth = 64, 32, 2, 4
    n = w * h * spp
    cfg = train.fit_config(RenderConfig(width=w, height=h, samples=spp,
                                        max_depth=depth, gamma=False,
                                        engine="mega_diff"))
    gen = torch.Generator().manual_seed(3)
    _, cam_cpu = presets.three_spheres(2.0, device="cpu")
    rays = generate_pixel_rays(cam_cpu, w, h, spp, generator=gen)
    stream = stream_from_generator(gen, n, depth, "cpu")
    out = []
    for dev in ("cpu", cuda):
        scene, cam = presets.three_spheres(2.0, device=dev)
        r = type(rays)(*(x.to(dev) for x in rays))
        st = integ.SampleStream(stream.ball.to(dev), stream.prob.to(dev))
        pix = torch.arange(w * h, device=dev)
        with torch.no_grad():
            target = render_pixels(scene, cam, cfg, pix, rays=r, samples=st)
        params = {"albedo": (scene.textures.color0 * 0.6 + 0.1)
                  .requires_grad_(),
                  "centers": (scene.spheres.center + 0.05).requires_grad_()}
        mk.reset_launch_counts()
        loss, grads = train.value_and_grad(scene, params, cam, cfg, pix,
                                           target, rays=r, samples=st)
        if dev is cuda:
            assert mk.LAUNCHES["mega_winners"] > 0
        out.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    (l_cpu, g_cpu), (l_dev, g_dev) = out
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    for k in g_cpu:
        scale = float(g_cpu[k].abs().max())
        assert scale > 0
        assert float((g_dev[k] - g_cpu[k]).abs().max()) <= 1e-3 * scale, k
    # the seed route on the card
    seed = 77
    draws = [mk.scatter_draws(torch.empty(n, 4, device=cuda), seed, step)
             for step in range(depth + 1)]
    counter = integ.SampleStream(torch.stack([x[:, :3] for x in draws]),
                                 torch.stack([x[:, 3] for x in draws]))
    wts = torch.rand(n, 3, generator=torch.Generator(device=cuda)
                     .manual_seed(2), device=cuda)
    got = []
    for kw in (dict(seed=seed), dict(samples=counter)):
        c = scene.spheres.center.clone().requires_grad_()
        sc = scene._replace(spheres=scene.spheres._replace(center=c))
        img = mk.trace_path_mega_diff(sc, r, cfg,
                                      tables=mk.morton_tables(sc), **kw)
        got.append(torch.autograd.grad((img * wts).sum(), [c])[0])
    # the scatter-adds of the backward use atomics: the order of the sums
    # may change from run to run
    assert float((got[0] - got[1]).abs().max()) <= 1e-6 * float(
        got[1].abs().max())


# ---------------------------------------------------------------------------
# Kernel mode K9 (image textures)
# ---------------------------------------------------------------------------

def _tex_frame(name, dev):
    """(scene, camera, cfg, launch index) of a full-size image frame: the
    middle launch of random_spheres with images 1920x1080x16 (fixed or
    reference quirks) and of the textured icosphere 1280x720x8 (fixed), the
    first of textured_globe 1280x720x16 (reference)."""
    if name.startswith("tex_spheres"):
        scene, cam = presets.random_spheres(16 / 9, textured=True,
                                            device=dev)
        quirks = (Quirks.fixed() if name.endswith("fixed")
                  else Quirks.reference())
        cfg = RenderConfig(width=1920, height=1080, samples=16,
                           max_depth=DEPTH, quirks=quirks, engine="mega")
        return scene, cam, cfg, 63
    if name == "tex_icosphere":
        scene, cam = cs.tex_icosphere_scene(16 / 9, device=dev)
        cfg = RenderConfig(width=1280, height=720, samples=8,
                           max_depth=DEPTH, quirks=Quirks.fixed(),
                           engine="mega")
        return scene, cam, cfg, 14
    scene, cam = presets.textured_globe(16 / 9, device=dev)
    cfg = RenderConfig(width=1280, height=720, samples=16, max_depth=DEPTH,
                       engine="mega")
    return scene, cam, cfg, 0


def _assert_texels_match(got, ref):
    """Every ray to 1e-5 except at most max(2, n / 10^4) flipped texels."""
    assert torch.isfinite(got).all()
    n = got.shape[0]
    flips = int(((got - ref).abs().amax(dim=1) > ATOL).sum())
    assert flips <= max(2, n // 10 ** 4), flips


TEX_FRAMES = ["tex_spheres_fixed", "tex_spheres_reference", "tex_icosphere",
              "textured_globe"]


@pytest.mark.gpu
@pytest.mark.parametrize("frame", TEX_FRAMES)
def test_tex_kernel_matches_plain_on_a_full_launch(cuda, frame):
    """K9: one full 2^18-ray launch of each image frame, the three
    integrators on an injected stream (normal takes the instance without
    TEX) and the path on in-kernel draws."""
    scene, cam, cfg, k = _tex_frame(frame, cuda)
    rays = _first_launch(cam, cfg, cuda, 23, k)
    n = rays.origin.shape[0]
    assert n == cfg.ray_chunk
    tables = mk.morton_tables(scene)
    stream = stream_from_generator(torch.Generator(device=cuda).manual_seed(6),
                                   n, DEPTH, cuda)
    st = mk.stream_tensor(stream, n, DEPTH + 1)
    mk.reset_launch_counts()
    for integrator in INTEGRATORS:
        c = dataclasses.replace(cfg, integrator=integrator)
        got = mk.trace_path_mega(scene, rays, c, tables=tables,
                                 samples=stream)
        _assert_texels_match(got, mk.trace_path_mega_plain(tables, rays, c,
                                                           st))
    got = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=8)
    _assert_texels_match(got, mk.trace_path_mega_plain(tables, rays, cfg,
                                                       None, 8))
    assert mk.LAUNCHES["mega_trace_tex"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["tex_spheres_fixed", "textured_globe"])
def test_tex_winners_match_plain(cuda, frame):
    """K7 on K9: the winners of one full launch equal the plain version's on
    every ray and bounce, and recording leaves the radiance unchanged."""
    scene, cam, cfg, k = _tex_frame(frame, cuda)
    rays = _first_launch(cam, cfg, cuda, 29, k)
    tables = mk.morton_tables(scene)
    got, win = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=31,
                                  want_winners=True)
    plain = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=31)
    ref, wref = mk.trace_path_mega_plain(tables, rays, cfg, None, 31,
                                         want_winners=True)
    assert torch.equal(got, plain)
    _assert_texels_match(got, ref)
    assert torch.equal(win, wref)


@pytest.mark.gpu
@pytest.mark.parametrize("frame", TEX_FRAMES[1:])
def test_tex_fused_matches_the_wavefront(cuda, frame):
    """The fused engine (K9) and the wavefront (sweeps, images read by
    tensor ops) on the same 2^18 rays and injected stream."""
    scene, cam, cfg, k = _tex_frame(frame, cuda)
    rays = _first_launch(cam, cfg, cuda, 37, k)
    n = rays.origin.shape[0]
    stream = stream_from_generator(torch.Generator(device=cuda).manual_seed(
        38), n, DEPTH, cuda)
    wcfg = dataclasses.replace(cfg, engine="wavefront")
    with torch.no_grad():
        wave = integ.integrate(scene, rays, wcfg, samples=stream,
                               intersect_fn=sweep_intersector_pair(wcfg))
    mega = mk.trace_path_mega(scene, rays, cfg, tables=mk.morton_tables(scene),
                              samples=stream)
    assert torch.isfinite(wave).all()
    assert int(((wave - mega).abs().amax(dim=1) > 1e-3).sum()) <= max(
        2, n // 200)


@pytest.mark.gpu
def test_mega_diff_on_images_card_matches_the_cpu(cuda):
    """One mega_diff value-and-grad (K7 and K9 forward, replay backward
    reading the images) on textured_globe at 64x32x2 on one injected
    stream: loss and gradients on the card against the plain CPU run."""
    w, h, spp, depth = 64, 32, 2, 4
    n = w * h * spp
    cfg = train.fit_config(RenderConfig(width=w, height=h, samples=spp,
                                        max_depth=depth, gamma=False,
                                        engine="mega_diff"))
    gen = torch.Generator().manual_seed(3)
    _, cam_cpu = presets.textured_globe(2.0, device="cpu")
    rays = generate_pixel_rays(cam_cpu, w, h, spp, generator=gen)
    stream = stream_from_generator(gen, n, depth, "cpu")
    out = []
    for dev in ("cpu", cuda):
        scene, cam = presets.textured_globe(2.0, device=dev)
        r = type(rays)(*(x.to(dev) for x in rays))
        st = integ.SampleStream(stream.ball.to(dev), stream.prob.to(dev))
        pix = torch.arange(w * h, device=dev)
        with torch.no_grad():
            target = render_pixels(scene, cam, cfg, pix, rays=r, samples=st)
        params = {"albedo": (scene.textures.color0 * 0.6 + 0.1)
                  .requires_grad_(),
                  "centers": (scene.spheres.center + 0.05).requires_grad_()}
        mk.reset_launch_counts()
        loss, grads = train.value_and_grad(scene, params, cam, cfg, pix,
                                           target, rays=r, samples=st)
        if dev is cuda:
            assert mk.LAUNCHES["mega_winners"] > 0
            assert mk.LAUNCHES["mega_trace_tex"] > 0
        out.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    (l_cpu, g_cpu), (l_dev, g_dev) = out
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    for k in g_cpu:
        scale = float(g_cpu[k].abs().max())
        assert scale > 0
        assert float((g_dev[k] - g_cpu[k]).abs().max()) <= 1e-3 * scale, k


# ---------------------------------------------------------------------------
# The sweeps K3, K4, K5 and the wavefront
# ---------------------------------------------------------------------------

T_MIN, T_MAX = 1e-3, sw.BIG


def _hits_match(got, ref):
    assert torch.equal(got[1], ref[1])
    for a, b in zip(got[::2], ref[::2]):
        assert float((a - b).abs().max()) <= ATOL
    assert bool((got[1] >= 0).any())


def _bounced(scene, rays, cfg, seed):
    """The rays after one wavefront bounce, and a random alive mask."""
    n = rays.origin.shape[0]
    draws = mk.scatter_draws(torch.empty(n, 4, device=rays.origin.device),
                             seed, 0)
    with torch.no_grad():
        o, d, t, _, _, cont, _ = integ._bounce(
            scene, cfg, sweep_intersector(cfg, True), 0, None, None, *rays,
            torch.ones_like(rays.origin), torch.zeros_like(rays.origin),
            torch.ones(n, dtype=torch.bool, device=rays.origin.device),
            draws[:, :3], draws[:, 3])
    keep = torch.rand(n, generator=torch.Generator(
        device=o.device).manual_seed(seed), device=o.device) < 0.7
    return o, d, cont & keep


@pytest.mark.gpu
@pytest.mark.parametrize("attrs", [False, True])
@pytest.mark.parametrize("cull", [False, True])
def test_sphere_sweeps_match_plain(cuda, cull, attrs):
    """K3 / K5 on random_spheres (Morton order, as the trace runs it):
    camera rays, then bounced rays with an alive mask of every ray and a
    thinned one (dead lanes miss).  K5's attributes [N, 21] bit-equal to
    the plain version's, a dead lane carrying prim 0's row."""
    scene, cam = presets.random_spheres(2.0, device=cuda)
    scene = integ._morton_scene(scene)[0]
    sp = scene.spheres
    cfg = RenderConfig(width=64, height=32, samples=4, max_depth=DEPTH)
    rays = generate_pixel_rays(cam, 64, 32, 4, generator=torch.Generator(
        device=cuda).manual_seed(6))
    tbl = isect.sphere_attr_table(scene)
    bo, bd, alive = _bounced(scene, rays, cfg, 8)
    for o, d, al in ((rays.origin, rays.direction, None),
                     (bo, bd, torch.ones_like(alive)), (bo, bd, alive)):
        before = dict(sw.LAUNCHES)
        if attrs:
            got = sw.sphere_best_hit_attrs_raw(o, d, sp.center, sp.radius,
                                               tbl, T_MIN, T_MAX, cull, al)
            ref = sw.sphere_best_hit_attrs_plain(o, d, sp.center, sp.radius,
                                                 tbl, T_MIN, T_MAX, al)
            key = "sphere_sweep_attrs"
        else:
            got = sw.sphere_best_hit_raw(o, d, sp.center, sp.radius, T_MIN,
                                         T_MAX, cull, al)
            ref = sw.sphere_best_hit_plain(o, d, sp.center, sp.radius, T_MIN,
                                           T_MAX, al)
            key = "sphere_sweep"
        torch.cuda.synchronize()
        assert sw.LAUNCHES[key] == before[key] + 1
        _hits_match(got, ref)
        if attrs:
            assert tuple(got[2].shape) == (o.shape[0], tbl.shape[0])
            assert torch.equal(got[2], ref[2])
        if al is not None:
            assert bool((got[1][~al] == -1).all())
            assert bool((got[0][~al] == sw.BIG).all())
            if attrs:
                assert bool((got[2][~al] == tbl[:, 0]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_triangle_sweep_matches_plain(cuda, profile, cull):
    """K4 on the icosphere (5,120 triangles) and on the mixed scene (5
    triangles), camera and bounced rays."""
    quirks = getattr(Quirks, profile)()
    for scene, cam in (cs.icosphere_scene(2.0, device=cuda),
                       cs.mixed_scene(cuda)):
        scene = integ._morton_scene(scene)[0]
        tr = scene.triangles
        cfg = RenderConfig(width=64, height=32, samples=4, max_depth=DEPTH,
                           quirks=quirks)
        rays = generate_pixel_rays(cam, 64, 32, 4, generator=torch.Generator(
            device=cuda).manual_seed(2))
        bo, bd, alive = _bounced(scene, rays, cfg, 4)
        for o, d, al in ((rays.origin, rays.direction, None),
                         (bo, bd, alive)):
            got = sw.triangle_best_hit_raw(o, d, tr.v0, tr.v1, tr.v2,
                                           tr.normal, T_MIN, T_MAX, quirks,
                                           cull, al)
            ref = sw.triangle_best_hit_plain(o, d, tr.v0, tr.v1, tr.v2,
                                             tr.normal, T_MIN, T_MAX, quirks,
                                             al)
            if al is None or bool((ref[1] >= 0).any()):
                _hits_match(got, ref)
            else:
                assert torch.equal(got[1], ref[1])


@pytest.mark.gpu
def test_sweeps_keep_the_first_prim_on_ties(cuda):
    """Duplicated prims never win, and exact ties go to the lowest id,
    across chunks and from a sphere over a triangle."""
    from cudaraytracer_tpu_torch.core.rays import make_rays
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    scene, cam = cs.duplicate_scene(cuda)
    rays = generate_pixel_rays(cam, 64, 32, 4, generator=torch.Generator(
        device=cuda).manual_seed(1))
    sp, tr = scene.spheres, scene.triangles
    for cull in (False, True):
        got = sw.sphere_best_hit_raw(rays.origin, rays.direction, sp.center,
                                     sp.radius, T_MIN, T_MAX, cull)
        _hits_match(got, sw.sphere_best_hit_plain(
            rays.origin, rays.direction, sp.center, sp.radius, T_MIN, T_MAX))
        assert not bool(((got[1] == 2) | (got[1] == 4)).any())
        got = sw.triangle_best_hit_raw(rays.origin, rays.direction, tr.v0,
                                       tr.v1, tr.v2, tr.normal, T_MIN, T_MAX,
                                       Quirks.fixed(), cull)
        assert bool((got[1] == 0).any()) and not bool((got[1] == 1).any())
    tie = cs.fill_tie_scene(SceneBuilder()).build(cuda)
    rays = make_rays(cs.TIE_ORIGINS, cs.TIE_DIRECTIONS, device=cuda)
    for policy in ("all", "off"):
        hits = isect.intersect_scene_sweeps(tie, rays, quirks=Quirks.fixed(),
                                            sphere_cull=policy)
        assert hits.prim.tolist() == [22, 0]


@pytest.mark.gpu
def test_wavefront_render_runs_the_kernels(cuda):
    """render_image on the wavefront launches K3 and K2 (and K4 on a
    triangle scene) and agrees with the fused engine on the same seeds."""
    scene, cam = cs.mixed_scene(cuda)
    cfg = RenderConfig(width=64, height=32, samples=4, max_depth=DEPTH,
                       ray_chunk=4096)
    mk.reset_launch_counts()
    sw.reset_launch_counts()
    with torch.no_grad():
        img = render_image(scene, cam, cfg,
                           intersect_fn=sweep_intersector(cfg))
    assert sw.LAUNCHES["sphere_sweep"] > 0
    assert sw.LAUNCHES["triangle_sweep"] > 0
    assert mk.LAUNCHES["scatter_draws"] > 0
    assert img.is_cuda and torch.isfinite(img).all()
    mega = render_image(scene, cam, dataclasses.replace(cfg, engine="mega"))
    assert float(((img - mega).abs() > 1e-3).float().mean()) <= 0.05


@pytest.mark.gpu
def test_sweep_gradients_on_the_card_match_the_cpu(cuda):
    """The winner-only backwards run on the card and agree with the CPU."""
    gen = torch.Generator().manual_seed(0)
    o = torch.rand(512, 3, generator=gen) - 0.5
    d = torch.cat([torch.rand(512, 2, generator=gen) - 0.5,
                   -torch.ones(512, 1)], 1)
    center = torch.tensor([[0.0, 0.0, -4.0], [0.4, 0.1, -6.0]])
    radius = torch.tensor([1.0, 0.7])
    v0, v1, v2 = (torch.tensor([[-2.0, -2.0, -3.0]]),
                  torch.tensor([[2.0, -2.0, -3.5]]),
                  torch.tensor([[0.0, 2.0, -3.2]]))
    normal = torch.tensor([[0.0, 0.0, -1.0]])
    out = []
    for dev in ("cpu", cuda):
        leaves = [x.to(dev).requires_grad_() for x in
                  (o, d, center, radius, v0, v1, v2)]
        lo, ld, lc, lr, a, b, c = leaves
        ts, _ = sw.sphere_best_hit(lo, ld, lc, lr, T_MIN, T_MAX, True)
        tt, it = sw.triangle_best_hit(lo, ld, a, b, c, normal.to(dev),
                                      T_MIN, T_MAX, Quirks.fixed())
        loss = (torch.where(ts < 1e30, ts, 0.0).square().sum()
                + torch.where(it >= 0, tt, 0.0).sum())
        out.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for g_cpu, g_dev in zip(*out):
        assert torch.isfinite(g_dev).all()
        assert float((g_dev - g_cpu).abs().max()) <= 1e-4 * max(
            1.0, float(g_cpu.abs().max()))


def _winner_case(case, dev):
    """(idx, row blocks, slots, the form the launch must take) of one
    winner-sum case: 2^18 rays, K5's blocks (centre, radius, the 21
    attributes) over 484 spheres, or K4's three vertices over 10^5
    triangles (the global form)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    n, c = 1 << 18, 484

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    if case in ("global", "ordered_large"):
        c = 100_000
    idx = torch.randint(-1, c, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    if case == "one_winner":
        idx.fill_(5)
    elif case == "all_miss":
        idx.fill_(-1)
    elif case in ("hot_and_miss", "global", "ordered", "ordered_large"):
        r = torch.rand(n, generator=gen, device=dev)
        idx = torch.where(r < 0.6, -1, torch.where(
            r < 0.9, 0, torch.where(r < 0.97, 3, idx))).to(torch.int32)
    if case == "strided":           # column views, planes seen as rows
        blocks = (randn(n, 8)[:, 2:5], randn(n, 4)[:, 1], randn(21, n).t())
    elif case in ("global", "ordered_large"):
        blocks = (randn(n, 3), randn(n, 3), randn(n, 3))
    else:
        blocks = (randn(n, 3), randn(n), randn(n, 21))
    form = case if case == "global" else "shared"
    return idx, blocks, c, "ordered" if "ordered" in case else form


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "one_winner", "all_miss",
                                  "hot_and_miss", "strided", "global",
                                  "ordered", "ordered_large"])
def test_winner_add_matches_plain(cuda, case):
    """crt_winner_add against winner_add_plain (index_add_ over the hit
    lanes) on the card, in the form its shape takes, or under PyTorch's
    deterministic algorithms in the ordered form, which must repeat itself
    bit for bit.  Tolerance: 1e-5 of each sum's magnitude (the sum of the
    |values| added into it): the two sum in other orders, the plain
    version with atomics in a run-dependent one."""
    idx, blocks, c, form = _winner_case(case, cuda)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(form == "ordered", warn_only=True)
    try:
        sw.reset_launch_counts()
        got = sw.winner_add(idx, blocks, c)
        assert sw.LAUNCHES["winner_add"] == 1
        assert sw.LAUNCH_KINDS["winner_add"][form] == 1
        if form == "ordered":
            again = sw.winner_add(idx, blocks, c)
            assert all(torch.equal(a, g) for a, g in zip(again, got))
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    ref = sw.winner_add_plain(idx, blocks, c)
    mass = sw.winner_add_plain(idx, [b.double().abs() for b in blocks], c)
    for g, r, m in zip(got, ref, mass):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert bool(((g - r).double().abs() <= 1e-5 * m).all())
    if case == "all_miss":
        assert all(not g.any() for g in got)
    else:
        assert all(g.any() for g in got)


@pytest.mark.gpu
def test_fit_step_sums_each_bounce_in_one_winner_add(cuda):
    """A fit step's backward on random_spheres (K5 over 484 spheres, path
    depth 8) sums each bounce's gradients in one launch of the winner sum's
    shared form: 9 a step, and the card runs no index_add_."""
    scene, cam = presets.random_spheres(aspect=2.0, device=cuda)
    cfg = RenderConfig(width=64, height=32, samples=2, max_depth=DEPTH,
                       gamma=False)
    target = torch.rand(cfg.width * cfg.height, 3, device=cuda)
    params = {"albedo": (scene.textures.color0 * 0.6 + 0.1)
              .requires_grad_(),
              "centers": (scene.spheres.center + 0.05).requires_grad_()}
    step = train.make_fit_step(scene, cam, cfg, lr=0.1)
    step(params, target, torch.Generator(device=cuda).manual_seed(1))
    sw.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(params, target, torch.Generator(device=cuda).manual_seed(1))
        torch.cuda.synchronize()
    assert sw.LAUNCHES["winner_add"] == DEPTH + 1
    assert sw.LAUNCH_KINDS["winner_add"] == {
        **dict.fromkeys(sw.WINNER_FORMS, 0), "shared": DEPTH + 1}
    kernels = {e.key: e.count for e in prof.key_averages()}
    assert not [k for k in kernels if "indexFuncLargeIndex" in k]
    assert sum(n for k, n in kernels.items()
               if "crt_winner_add_shared" in k) == DEPTH + 1


@pytest.mark.gpu
def test_fit_step_on_the_card_matches_the_cpu(cuda):
    """One fit step (K5, K2 off: an injected stream) at 32x16x2: the loss
    and the gradients on the card against the plain CPU run."""
    w, h, spp, depth = 32, 16, 2, 3
    cfg = train.fit_config(RenderConfig(width=w, height=h, samples=spp,
                                        max_depth=depth, gamma=False))
    gen = torch.Generator().manual_seed(3)
    _, cam_cpu = presets.three_spheres(2.0, device="cpu")
    rays = generate_pixel_rays(cam_cpu, w, h, spp, generator=gen)
    stream = stream_from_generator(gen, w * h * spp, depth, "cpu")
    out = []
    for dev in ("cpu", cuda):
        scene, cam = presets.three_spheres(2.0, device=dev)
        r = type(rays)(*(x.to(dev) for x in rays))
        st = integ.SampleStream(stream.ball.to(dev), stream.prob.to(dev))
        pix = torch.arange(w * h, device=dev)
        fn = sweep_intersector_pair(cfg)
        with torch.no_grad():
            target = render_pixels(scene, cam, cfg, pix, rays=r, samples=st,
                                   intersect_fn=fn)
        params = {"albedo": (scene.textures.color0 * 0.6 + 0.1)
                  .requires_grad_(),
                  "centers": (scene.spheres.center + 0.05).requires_grad_()}
        sw.reset_launch_counts()
        loss, grads = train.value_and_grad(scene, params, cam, cfg, pix,
                                           target, intersect_fn=fn, rays=r,
                                           samples=st)
        if dev is cuda:
            assert sw.LAUNCHES["sphere_sweep_attrs"] > 0
        out.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    (l_cpu, g_cpu), (l_dev, g_dev) = out
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    for k in g_cpu:
        scale = float(g_cpu[k].abs().max())
        assert scale > 0
        assert float((g_dev[k] - g_cpu[k]).abs().max()) <= 1e-3 * scale, k


@pytest.mark.gpu
def test_sweeps_reject_bad_inputs(cuda):
    o = torch.zeros(4, 3, device=cuda)
    tbl, box, _ = sw.sphere_table(torch.zeros(3, 3, device=cuda),
                                  torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        sw.launch_sphere_sweep(o, torch.zeros(4, 3), tbl, box, None, None,
                               T_MIN, T_MAX)
    with pytest.raises(ValueError):
        sw.launch_sphere_sweep(o, o, tbl[:5], None, None, None, T_MIN, T_MAX)
    with pytest.raises(ValueError):
        sw.launch_triangle_sweep(o, o, torch.zeros(16, 9, device=cuda), None,
                                 None, T_MIN, T_MAX, Quirks.fixed())


def _every_instance(launch, ref, sup):
    """Every culled sweep instance (one and two box levels, one thread per
    ray and cooperative) against the plain version's hits ``ref``; the
    counting instances' box and prim tests, per instance."""
    counts = {}
    for s_ in (None,) if sup is None else (None, sup):
        for coop in (False, True):
            _hits_match(launch(sup=s_, coop=coop), ref)
            c = torch.zeros(sw.N_COUNTS, dtype=torch.int64,
                            device=ref[0].device)
            launch(sup=s_, coop=coop, counts=c)
            counts[(s_ is not None, coop)] = c.tolist()
    return counts


def _bounce_masks(scene, rays, cfg, seed):
    """(o, d, [the wavefront's alive mask after one bounce, that mask
    thinned to 70%])."""
    o, d, thin = _bounced(scene, rays, cfg, seed)
    n = rays.origin.shape[0]
    draws = mk.scatter_draws(torch.empty(n, 4, device=o.device), seed, 0)
    with torch.no_grad():
        cont = integ._bounce(
            scene, cfg, sweep_intersector(cfg, True), 0, None, None, *rays,
            torch.ones_like(rays.origin), torch.zeros_like(rays.origin),
            torch.ones(n, dtype=torch.bool, device=o.device),
            draws[:, :3], draws[:, 3])[5]
    return o, d, [cont, thin]


@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_triangle_sweep_instances_match_plain_on_bounces(cuda, profile):
    """K4's instances (one and two box levels, per thread and cooperative)
    on the icosphere's camera rays and its bounce with the wavefront's
    alive mask and with that mask thinned: the plain version's hits, and
    the cooperative and compacted instances count the per-thread tests."""
    quirks = getattr(Quirks, profile)()
    scene, cam = cs.icosphere_scene(2.0, device=cuda)
    scene = integ._morton_scene(scene)[0]
    tr = scene.triangles
    tbl, box, sup = sw.triangle_table(tr.v0, tr.v1, tr.v2, tr.normal)
    cfg = RenderConfig(width=128, height=64, samples=4, max_depth=DEPTH,
                       quirks=quirks)
    rays = generate_pixel_rays(cam, 128, 64, 4, generator=torch.Generator(
        device=cuda).manual_seed(12))
    o, d, masks = _bounce_masks(scene, rays, cfg, 12)
    for ro, rd, al in [(rays.origin, rays.direction, None)] + [
            (o, d, m) for m in masks]:
        ref = sw.triangle_best_hit_plain(ro, rd, tr.v0, tr.v1, tr.v2,
                                         tr.normal, T_MIN, T_MAX, quirks, al)
        counts = _every_instance(lambda **kw: sw.launch_triangle_sweep(
            ro, rd, tbl, box, al, T_MIN, T_MAX, quirks, **kw), ref, sup)
        for level in (False, True):
            assert counts[(level, True)][:2] == counts[(level, False)][:2]
        # the super level makes fewer box tests and the same prim tests
        assert counts[(True, False)][1] == counts[(False, False)][1]
        assert counts[(True, False)][0] < counts[(False, False)][0]


@pytest.mark.gpu
@pytest.mark.parametrize("scene_name", ["random_spheres", "sphere_field"])
def test_sphere_sweep_instances_match_plain_on_bounces(cuda, scene_name):
    """K3's and K5's instances on camera rays and bounced rays (both
    masks) of random_spheres (484 spheres) and of the 9,216-sphere field
    (above SPH_SUPER_MIN, where the public entry takes the super level)."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    if scene_name == "random_spheres":
        scene, cam = presets.random_spheres(2.0, device=cuda)
    else:
        from cudaraytracer_tpu_torch.core.camera import make_camera
        scene = cs.fill_sphere_field(SceneBuilder()).build(cuda)
        cam = make_camera((0.0, 3.0, 2.0), (0.0, 0.0, -12.0), vfov=60.0,
                          device=cuda)
    scene = integ._morton_scene(scene)[0]
    sp = scene.spheres
    tbl, box, sup = sw.sphere_table(sp.center, sp.radius)
    attr = isect.sphere_attr_table(scene)
    rows = sw.attr_rows(attr)
    cfg = RenderConfig(width=128, height=64, samples=4, max_depth=DEPTH)
    rays = generate_pixel_rays(cam, 128, 64, 4, generator=torch.Generator(
        device=cuda).manual_seed(13))
    o, d, masks = _bounce_masks(scene, rays, cfg, 13)
    for ro, rd, al in [(rays.origin, rays.direction, None)] + [
            (o, d, m) for m in masks]:
        ref = sw.sphere_best_hit_plain(ro, rd, sp.center, sp.radius, T_MIN,
                                       T_MAX, al)
        refa = sw.sphere_best_hit_attrs_plain(ro, rd, sp.center, sp.radius,
                                              attr, T_MIN, T_MAX, al)
        for r, ref_ in ((None, ref), (rows, refa)):
            counts = _every_instance(lambda **kw: sw.launch_sphere_sweep(
                ro, rd, tbl, box, al, r, T_MIN, T_MAX, **kw), ref_, sup)
            for level in {level for level, _ in counts}:
                assert (counts[(level, True)][:2]
                        == counts[(level, False)][:2])
        _hits_match(sw.sphere_best_hit_raw(ro, rd, sp.center, sp.radius,
                                           T_MIN, T_MAX, True, al), ref)


@pytest.mark.gpu
def test_sweep_instances_keep_the_first_prim_on_ties(cuda):
    """Every instance on the duplicate and tie scenes, and with a duplicate
    of an icosphere triangle appended in another super: the first copy
    wins every tie."""
    from cudaraytracer_tpu_torch.core.rays import make_rays
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    dup, cam = cs.duplicate_scene(cuda)
    rays = generate_pixel_rays(cam, 64, 32, 4, generator=torch.Generator(
        device=cuda).manual_seed(1))
    tie = cs.fill_tie_scene(SceneBuilder()).build(cuda)
    rays_t = make_rays(cs.TIE_ORIGINS, cs.TIE_DIRECTIONS, device=cuda)
    for scene, r in ((dup, rays), (tie, rays_t)):
        sp, tr = scene.spheres, scene.triangles
        tbl, box, sup = sw.sphere_table(sp.center, sp.radius)
        _every_instance(lambda **kw: sw.launch_sphere_sweep(
            r.origin, r.direction, tbl, box, None, None, T_MIN, T_MAX, **kw),
            sw.sphere_best_hit_plain(r.origin, r.direction, sp.center,
                                     sp.radius, T_MIN, T_MAX), sup)
        ttbl, tbox, tsup = sw.triangle_table(tr.v0, tr.v1, tr.v2, tr.normal)
        for s_ in (None, tsup):
            for coop in (False, True):
                got = sw.launch_triangle_sweep(
                    r.origin, r.direction, ttbl, tbox, None, T_MIN, T_MAX,
                    Quirks.fixed(), sup=s_, coop=coop)
                assert torch.equal(got[1], sw.triangle_best_hit_plain(
                    r.origin, r.direction, tr.v0, tr.v1, tr.v2, tr.normal,
                    T_MIN, T_MAX, Quirks.fixed())[1])
    scene, _ = cs.icosphere_scene(2.0, device=cuda)
    tr = scene.triangles
    k = 37
    v = [torch.cat([x, x[k:k + 1]]) for x in (tr.v0, tr.v1, tr.v2,
                                              tr.normal)]
    tbl, box, sup = sw.triangle_table(*v)
    assert box.shape[0] // sw.CHUNKS_PER_SUPER == 20     # the copy's super
    cen = (v[0][k] + v[1][k] + v[2][k]) / 3
    nrm = torch.linalg.cross(v[1][k] - v[0][k], v[2][k] - v[0][k])
    o = (cen + 0.5 * nrm / nrm.norm()).expand(4096, 3).contiguous()
    d = (cen - o) + 0.002 * torch.randn(4096, 3, device=cuda,
                                        generator=torch.Generator(
                                            device=cuda).manual_seed(2))
    ref = sw.triangle_best_hit_plain(o, d, *v, T_MIN, T_MAX, Quirks.fixed())
    assert bool((ref[1] == k).any())
    _every_instance(lambda **kw: sw.launch_triangle_sweep(
        o, d, tbl, box, None, T_MIN, T_MAX, Quirks.fixed(), **kw), ref, sup)


@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_sweeps_on_rays_along_box_planes(cuda, profile):
    """Axis-parallel rays whose origins lie on chunk and super planes (the
    slab's 0 * inf = NaN, which keeps a box reachable) and on the planes of
    the vertices' own chunk boxes (rays through shared vertices and edges,
    which the margin must keep): every instance finds the plain version's
    winners."""
    from cudaraytracer_tpu_torch.core.rays import make_rays
    quirks = getattr(Quirks, profile)()
    scene, _ = cs.icosphere_scene(2.0, device=cuda)
    scene = integ._morton_scene(scene)[0]
    tr = scene.triangles
    tbl, box, sup = sw.triangle_table(tr.v0, tr.v1, tr.v2, tr.normal)
    vertex_box = sw.group_boxes(
        torch.minimum(torch.minimum(tr.v0, tr.v1), tr.v2),
        torch.maximum(torch.maximum(tr.v0, tr.v1), tr.v2), sw.PRIM_CHUNK,
        sw.PRIM_CHUNK)
    for bx in (box, sup, vertex_box):
        o, d = cs.plane_rays(bx.cpu().numpy(), tr.v0.mean(0).cpu().numpy(),
                             8192, 5)
        r = make_rays(o, d, device=cuda)
        ref = sw.triangle_best_hit_plain(r.origin, r.direction, tr.v0, tr.v1,
                                         tr.v2, tr.normal, T_MIN, T_MAX,
                                         quirks)
        _every_instance(lambda **kw: sw.launch_triangle_sweep(
            r.origin, r.direction, tbl, box, None, T_MIN, T_MAX, quirks,
            **kw), ref, sup)


@pytest.mark.gpu
@pytest.mark.parametrize("band", [(1e-3, 1e-1), (1e-6, 1e-3)])
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_triangle_cull_keeps_every_hit_its_margin_covers(cuda, profile,
                                                         band):
    """A cylinder of slivers under grazing rays (moderate and extreme):
    every culled instance gives the same hits; the culled sweep leaves
    the plain version's (t, idx) only for a farther hit, and only where
    the plain winner is outside the margin's proof (ops/sweeps.py
    TRI_MARGIN, ``triangle_conditioned``)."""
    quirks = getattr(Quirks, profile)()
    v = [torch.as_tensor(x, device=cuda) for x in cs.sliver_cylinder()]
    order = sw.morton_argsort((v[0] + v[1] + v[2]) / 3)
    v0, v1, v2 = (x[order].contiguous() for x in v)
    nrm = torch.linalg.cross(v1 - v0, v2 - v0)
    o, d = (torch.as_tensor(x, device=cuda)
            for x in cs.grazing_rays(1 << 16, *band, seed=11))
    ref = sw.triangle_best_hit_plain(o, d, v0, v1, v2, nrm, T_MIN, T_MAX,
                                     quirks)
    tbl, box, sup = sw.triangle_table(v0, v1, v2, nrm)
    got = [sw.launch_triangle_sweep(o, d, tbl, box, None, T_MIN, T_MAX,
                                    quirks, sup=s_, coop=coop)
           for s_ in (None, sup) for coop in (False, True)]
    got.append(sw.triangle_best_hit_raw(o, d, v0, v1, v2, nrm, T_MIN, T_MAX,
                                        quirks))
    t, i = got[0]
    for g in got[1:]:
        assert torch.equal(g[0], t) and torch.equal(g[1], i)
    w = ref[1].long().clamp(min=0)
    covered = sw.triangle_conditioned(d, v1[w] - v0[w], v2[w] - v0[w])
    lost = (i != ref[1]) | (t != ref[0])
    assert not bool((lost & covered & (ref[1] >= 0)).any())
    assert bool((t >= ref[0]).all())
    assert bool((ref[1] >= 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["icosphere", "mixed", "three_spheres"])
def test_tables_built_once_per_trace_give_the_same_frame(cuda, name):
    """The wavefront with the sweep tables built once per trace (what
    trace_path does on the card) and with each sweep building its own (an
    intersector without ``build_tables``): the same frame, bit for bit;
    the sweeps count their camera and bounce launches by kind."""
    if name == "icosphere":
        scene, cam = cs.icosphere_scene(2.0, device=cuda)
    elif name == "mixed":
        scene, cam = cs.mixed_scene(cuda)
    else:
        scene, cam = presets.three_spheres(2.0, device=cuda)
    cfg = RenderConfig(width=64, height=32, samples=4, max_depth=DEPTH,
                       wavefront_kernel_attrs=name == "three_spheres")
    once = sweep_intersector(cfg)
    per_call = sweep_intersector(cfg)
    del per_call.build_tables
    imgs = []
    for fn in (once, per_call):
        sw.reset_launch_counts()
        with torch.no_grad():
            imgs.append(render_image(scene, cam, cfg, intersect_fn=fn))
        kinds = {k: v for k, v in sw.LAUNCH_KINDS.items() if sw.LAUNCHES[k]}
        assert kinds and all(v["camera"] >= 1 and v["bounce"] >= 1
                             for v in kinds.values())
        assert all(v["camera"] + v["bounce"] == sw.LAUNCHES[k]
                   for k, v in kinds.items())
    assert torch.equal(imgs[0], imgs[1])


# ---------------------------------------------------------------------------
# Kernel modes K6 (segment level), K10 (bounce windows), K11 (shells)
# ---------------------------------------------------------------------------

def _big_field_launch(dev, seed=5):
    """(scene, Morton tables, cfg, rays) of the first 2^18-ray launch of
    the 128,000-triangle field at 1280x720x8, path depth 8, fixed quirks."""
    scene, cam = cs.big_field_scene(16 / 9, device=dev)
    cfg = RenderConfig(width=1280, height=720, samples=8, max_depth=DEPTH,
                       quirks=Quirks.fixed(), engine="mega")
    return scene, mk.morton_tables(scene), cfg, _first_launch(cam, cfg, dev,
                                                              seed)


def _rays_from_numpy(o, d, dev):
    from cudaraytracer_tpu_torch.core.rays import make_rays
    return make_rays(o, d, device=dev)


@pytest.mark.gpu
def test_segment_level_matches_plain_on_the_big_field(cuda):
    """K6 on one full main-path launch of the 128,000-triangle field: every
    ray to 1e-5 of the plain version's brute force, under injected and
    in-kernel draws, and the winners of K7 on K6 equal."""
    scene, tables, cfg, rays = _big_field_launch(cuda)
    assert tables.tri_seg.shape == (63, 8)
    n = rays.origin.shape[0]
    stream = stream_from_generator(torch.Generator(device=cuda).manual_seed(
        6), n, DEPTH, cuda)
    got = mk.trace_path_mega(scene, rays, cfg, tables=tables,
                             samples=stream)
    _assert_rays_match(got, mk.trace_path_mega_plain(
        tables, rays, cfg, mk.stream_tensor(stream, n, DEPTH + 1)))
    got, win = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=21,
                                  want_winners=True)
    ref, wref = mk.trace_path_mega_plain(tables, rays, cfg, None, 21, True)
    _assert_rays_match(got, ref)
    assert torch.equal(win, wref)


@pytest.mark.gpu
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_segment_level_matches_plain_on_the_sphere_field(cuda, integrator):
    """K6 over spheres: 9,216 spheres (segments, supers and chunks), 2^16
    rays from above, injected draws."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    scene = cs.fill_sphere_field(SceneBuilder()).build(cuda)
    tables = mk.morton_tables(scene)
    assert tables.sph_seg.shape == (5, 8) and tables.sph_super.shape[0] == 40
    rays = _rays_from_numpy(*cs.sphere_field_rays(1 << 16), cuda)
    cfg = RenderConfig(max_depth=DEPTH, integrator=integrator, engine="mega")
    stream = stream_from_generator(torch.Generator(device=cuda).manual_seed(
        7), 1 << 16, DEPTH, cuda)
    got = mk.trace_path_mega(scene, rays, cfg, tables=tables,
                             samples=stream)
    _assert_rays_match(got, mk.trace_path_mega_plain(
        tables, rays, cfg, mk.stream_tensor(stream, 1 << 16, DEPTH + 1)))


def _terrain_launch(dev, n=1 << 16):
    """(scene, Morton tables, cfg, rays) of the 10,368-triangle terrain
    (segments at run time) and n rays cast from above, path depth 8, fixed
    quirks."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    scene = cs.fill_terrain(SceneBuilder()).build(dev)
    cfg = RenderConfig(max_depth=DEPTH, engine="mega", quirks=Quirks.fixed())
    return (scene, mk.morton_tables(scene), cfg,
            _rays_from_numpy(*cs.terrain_rays(n), dev))


@pytest.mark.gpu
@pytest.mark.parametrize("field", ["big_field", "terrain"])
def test_phased_and_compact_equal_monolithic_on_the_card(cuda, field):
    """K10: the compaction drivers on the card are bit-equal to the
    monolithic launch, for every window length, with and without octant
    regrouping, with a first window of one bounce and through the compact
    driver, under in-kernel and injected draws (keyed by ray id), on 2^16
    rays of the 128,000-triangle field and of the terrain; and no driver
    waits on the host between its windows (sync debug mode "error")."""
    scene, tables, cfg, rays = (_big_field_launch(cuda) if field == "big_field"
                                else _terrain_launch(cuda))
    rays = type(rays)(*(x[:1 << 16] for x in rays))
    n = rays.origin.shape[0]
    stream = stream_from_generator(torch.Generator(device=cuda).manual_seed(
        12), n, DEPTH, cuda)
    runs = [dict(compact_every=e, octants=oc) for e in (1, 2, 3)
            for oc in (False, True)]
    runs.append(dict(compact_every=2, octants=True, first_window=1))
    for draws in (dict(seed=8), dict(samples=stream)):
        want = mk.trace_path_mega(scene, rays, cfg, tables=tables, **draws)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [mk.trace_path_mega_phased(scene, rays, cfg, tables=tables,
                                             **run, **draws) for run in runs]
            got.append(mk.trace_path_mega_compact(
                scene, rays, cfg, tables=tables, primary_steps=2, **draws))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for run, g in zip(runs + ["compact"], got):
            assert torch.equal(g, want), (run, list(draws))


@pytest.mark.gpu
def test_window_planes_match_plain_on_the_card(cuda):
    """K10 in place on 2^16 camera rays of a 20,480-triangle field (the
    cooperative sweep): the window [0, 2) writes every ray's planes and its
    key in each of the three key modes as the plain version does; [2, 5),
    served in the sorted order of the octant keys, matches the plain
    version's planes and keys, dead rays' columns untouched; and [5, 9) in
    the next order completes the monolithic launch's radiance bit for
    bit."""
    scene, cam = cs.field_scene(2, 2, 16 / 9, device=cuda)
    tables = mk.morton_tables(scene)
    assert tables.tri_seg.shape[0] == 10
    cfg = RenderConfig(width=1280, height=720, samples=8, max_depth=DEPTH,
                       quirks=Quirks.fixed(), engine="mega")
    rays = _first_launch(cam, cfg, cuda, 3)
    rays = type(rays)(*(x[:1 << 16] for x in rays))
    n = rays.origin.shape[0]
    want = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=8)

    def both(win):
        """The window on the card and in the plain version from the same
        planes and keys -> the card's (planes, key), checked equal."""
        ref = win._replace(planes=win.planes.clone(), key=win.key.clone())
        mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=8,
                           window=win)
        mk.trace_path_mega_plain(tables, rays, cfg, None, 8, window=ref)
        assert torch.equal(win.planes, ref.planes)
        assert torch.equal(win.key, ref.key)
        return win.planes, win.key

    for mode in (mk.KEY_ALIVE, mk.KEY_MORTON, mk.KEY_OCTANT):
        planes = torch.full((mk.N_PLANES, n), float("nan"), device=cuda)
        key = torch.full((n,), -1, dtype=torch.int32, device=cuda)
        planes, key = both(mk.Window(0, 2, planes, None, key, mode))
        assert not planes.isnan().any() and bool((key >= 0).all())
    alive = planes[12] > 0
    assert 0 < int(alive.sum()) < n
    dead = planes[:, ~alive].clone()
    planes, key = both(mk.Window(2, 3, planes, mk._next_order(key), key,
                                 mk.KEY_OCTANT))
    assert torch.equal(planes[:, ~alive], dead)
    mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=8,
                       window=mk.Window(5, None, planes, mk._next_order(key)))
    assert torch.equal(planes[:3].t(), want)


@pytest.mark.gpu
def test_cooperative_shells_make_the_per_thread_tests(cuda):
    """K11 under the cooperative sweep against one thread per ray, 1 to 256
    shells (above 32, in groups of 32) over the 128,000-triangle field's 63
    segments (2^16 rays) and 8 shells over the 1M-triangle field's 510
    (2^12 rays, 66 KB of dynamic shared memory a block): equal test counts
    (the box distances ranked among them), touched chunks and radiance.
    Above MAX_SHELLS the launch sweeps one thread per ray and still gives
    the table order's radiance."""
    scene, tables, cfg, rays = _big_field_launch(cuda)
    cases = [(tables, type(rays)(*(x[:1 << 16] for x in rays)), b)
             for b in (1, 3, 8, 40, 256, mk.MAX_SHELLS + 44)]
    big, cam = cs.big1m_scene(16 / 9, device=cuda)
    big_tables = mk.morton_tables(big)
    assert big_tables.tri_seg.shape[0] == 510
    cases.append((big_tables, type(rays)(*(x[:1 << 12] for x in
                                           _first_launch(cam, cfg, cuda, 4))),
                  8))
    for t, r, shells in cases:
        c = dataclasses.replace(cfg, mega_f2b_shells=shells)
        out, counts, touched = _counted(t, r, c, False)
        out_pt, counts_pt, touched_pt = _counted(t, r, c, True)
        assert torch.equal(counts, counts_pt), (shells, counts.tolist(),
                                                counts_pt.tolist())
        assert torch.equal(touched, touched_pt) and torch.equal(out, out_pt)
        assert int(counts[7]) >= r.origin.shape[0] * t.tri_seg.shape[0]
        got = mk.trace_path_mega(scene if t is tables else big, r, c,
                                 tables=t, seed=17)
        pt = mk._launch_mega(t, r.origin.contiguous(),
                             r.direction.contiguous(), c, None, 17,
                             per_thread=True)
        assert torch.equal(got, pt), shells
        if shells > mk.MAX_SHELLS:
            assert torch.equal(got, mk.trace_path_mega(
                scene, r, dataclasses.replace(c, mega_f2b_shells=0),
                tables=t, seed=17))


@pytest.mark.gpu
def test_shells_equal_table_order_on_the_card(cuda):
    """K11: eight front-to-back shells over the field's 63 segments give the
    table-order radiance and winners bit for bit; the routed default
    (select_mega: phased, octants, shells 8) equals the monolithic launch."""
    scene, tables, cfg, rays = _big_field_launch(cuda)
    want, wwin = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=9,
                                    want_winners=True)
    before = mk.LAUNCHES["mega_f2b"]
    got, win = mk.trace_path_mega(
        scene, rays, dataclasses.replace(cfg, mega_f2b_shells=8),
        tables=tables, seed=9, want_winners=True)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["mega_f2b"] == before + 1
    assert torch.equal(got, want) and torch.equal(win, wwin)
    routed = integ.integrate(scene, rays, cfg, tables=tables, seed=9)
    assert torch.equal(routed, want)


# ---------------------------------------------------------------------------
# Kernel mode K12 (cfg.mega_mxu) and the animation driver
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_mxu_sweep_matches_plain_on_the_terrain(cuda, profile):
    """K12 on the 10,368-triangle terrain (2^16 rays from above): every ray
    to 1e-5 of the plain version's bilinear sweep, three integrators on an
    injected stream and the path on in-kernel draws; under the reference
    quirks it runs the d.n block and the no-t-clip window.  The launch
    counts as K12 and K6, never as K11, also with shells asked."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    scene = cs.fill_terrain(SceneBuilder()).build(cuda)
    tables = mk.morton_tables(scene, mxu=True)
    n = 1 << 16
    rays = _rays_from_numpy(*cs.terrain_rays(n), cuda)
    base = RenderConfig(max_depth=DEPTH, engine="mega", mega_mxu=True,
                        mega_f2b_shells=8, quirks=getattr(Quirks, profile)())
    stream = stream_from_generator(torch.Generator(device=cuda).manual_seed(
        8), n, DEPTH, cuda)
    st = mk.stream_tensor(stream, n, DEPTH + 1)
    for integrator in INTEGRATORS:
        cfg = dataclasses.replace(base, integrator=integrator)
        mk.reset_launch_counts()
        got = mk.trace_path_mega(scene, rays, cfg, tables=tables,
                                 samples=stream)
        torch.cuda.synchronize()
        assert mk.LAUNCHES["mega_mxu"] == 1 and mk.LAUNCHES["mega_f2b"] == 0
        _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, cfg,
                                                         st))
    got = mk.trace_path_mega(scene, rays, base, tables=tables, seed=31)
    _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, base,
                                                     None, 31))


@pytest.mark.gpu
def test_mxu_sweep_matches_plain_on_the_big_field(cuda):
    """K12 on 2^16 rays of the 128,000-triangle field's first launch:
    every ray to 1e-5 of the plain version, the phased driver (octants)
    bit-equal to the monolithic launch; tables without coefficients
    raise."""
    scene, tables, cfg, rays = _big_field_launch(cuda)
    rays = type(rays)(*(x[:1 << 16] for x in rays))
    cfg = dataclasses.replace(cfg, mega_mxu=True)
    with pytest.raises(ValueError, match="mxu=True"):
        mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=4)
    tables = mk.morton_tables(scene, mxu=True)
    got = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=4)
    _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, cfg, None,
                                                     4))
    ph = mk.trace_path_mega_phased(scene, rays, cfg, tables=tables,
                                   compact_every=2, seed=4, octants=True)
    assert torch.equal(ph, got)


@pytest.mark.gpu
def test_tied_terrain_ties_go_to_the_lowest_row(cuda):
    """The terrain with an exact copy of every fifth triangle in another
    colour, each copy behind its original in one chunk, across two lanes
    of one 32-triangle batch, across supers or across segments
    (check_scenes.tied_terrain_order), 2^16 rays: K6 (path, winners
    recorded), K11 (8 shells) and K12 (lambert and path) give the plain
    version's radiance, every tie to the lower row, so no winner is a copy
    and the winners equal the plain version's."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    scene = cs.fill_tied_terrain(SceneBuilder()).build(cuda)
    tables = mk.build_mega_tables(scene, cs.tied_terrain_order(), mxu=True)
    n = 1 << 16
    rays = _rays_from_numpy(*cs.terrain_rays(n), cuda)
    cfg = RenderConfig(max_depth=DEPTH, engine="mega",
                       quirks=Quirks.fixed())
    ref, wref = mk.trace_path_mega_plain(tables, rays, cfg, None, 13, True)
    tri = wref - scene.n_spheres
    assert not bool((tri >= 2 * 72 * 72).any())    # the copies' ids
    assert int(((tri >= 0) & (tri % cs.TIE_EVERY == 0)).sum()) > 1000
    for shells in (0, 8):
        c = dataclasses.replace(cfg, mega_f2b_shells=shells)
        got, win = mk.trace_path_mega(scene, rays, c, tables=tables, seed=13,
                                      want_winners=True)
        _assert_rays_match(got, ref)
        assert torch.equal(win, wref), shells
        assert torch.equal(mk.trace_path_mega(scene, rays, c, tables=tables,
                                              seed=13), got)
    for integrator in ("path", "lambert"):
        c = dataclasses.replace(cfg, integrator=integrator, mega_mxu=True)
        mk.reset_launch_counts()
        got = mk.trace_path_mega(scene, rays, c, tables=tables, seed=13)
        torch.cuda.synchronize()
        assert mk.LAUNCHES["mega_mxu"] == 1
        _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, c,
                                                         None, 13))


def _counted(tables, rays, cfg, per_thread):
    counts = torch.zeros(mk.N_COUNTS, dtype=torch.int64,
                         device=rays.origin.device)
    touched = torch.zeros(tables.sph_box.shape[0] + tables.tri_box.shape[0],
                          dtype=torch.uint8, device=rays.origin.device)
    out = mk._launch_mega(tables, rays.origin.contiguous(),
                          rays.direction.contiguous(), cfg, None, 17,
                          counts=counts, touched=touched,
                          per_thread=per_thread)
    return out, counts, touched


@pytest.mark.gpu
def test_cooperative_sweeps_make_the_per_thread_tests(cuda):
    """On the first 2^18-ray launch of the 128,000-triangle field, the
    cooperative sweeps (K6, K11's 8 shells, K12) count the same tests and
    touch the same chunks as the one-thread-per-ray counting instances on
    the same rays (K12's tri_done among them), and render what they
    render, and K6's production launch equals the per-thread one."""
    scene, tables, cfg, rays = _big_field_launch(cuda)
    mxu_tables = mk.morton_tables(scene, mxu=True)
    for t, c in ((tables, cfg),
                 (tables, dataclasses.replace(cfg, mega_f2b_shells=8)),
                 (mxu_tables, dataclasses.replace(cfg, mega_mxu=True))):
        out, counts, touched = _counted(t, rays, c, False)
        out_pt, counts_pt, touched_pt = _counted(t, rays, c, True)
        assert torch.equal(counts, counts_pt), (counts.tolist(),
                                                counts_pt.tolist())
        assert torch.equal(touched, touched_pt)
        assert torch.equal(out, out_pt)
        assert int(counts[2]) > 0
    got = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=17)
    pt = mk._launch_mega(tables, rays.origin.contiguous(),
                         rays.direction.contiguous(), cfg, None, 17,
                         per_thread=True)
    assert torch.equal(got, pt)
    with pytest.raises(ValueError, match="counting instance only"):
        mk._launch_mega(mxu_tables, rays.origin.contiguous(),
                        rays.direction.contiguous(),
                        dataclasses.replace(cfg, mega_mxu=True), None, 17,
                        per_thread=True)


@pytest.mark.gpu
def test_animate_runs_on_the_card(cuda, tmp_path):
    """apps/animate.py's loop on the card, 2 frames of the skinned capsule
    at 64x32x1: the mega pipeline launches the fused kernel, pallas the
    triangle sweep, and the three pipelines' frames agree with each other
    to 1e-4 and with the CPU's in their mean and mesh share."""
    from cudaraytracer_tpu_torch.apps import animate
    cap = cs.skinned_capsule()
    images = {}
    for pipeline in ("mega", "pallas", "list"):
        argv = ["--width", "64", "--height", "32", "--samples", "1",
                "--frames", "2", "--begin-frame", "29", "--pipeline",
                pipeline, "--out", str(tmp_path / pipeline), "--csv",
                str(tmp_path / f"{pipeline}.csv")]
        mk.reset_launch_counts()
        sw.reset_launch_counts()
        run = animate.animate(cap, animate.parse_args(argv))
        assert run.frames == [29, 30]
        if pipeline == "mega":
            assert mk.LAUNCHES["mega_trace"] == 2
        if pipeline == "pallas":
            assert sw.LAUNCHES["triangle_sweep"] >= 2
        images[pipeline] = run.image
        assert (tmp_path / pipeline / "picture_30.png").exists()
    cpu = animate.animate(cap, animate.parse_args(argv + [
        "--pipeline", "mega", "--cpu", "--no-png", "--out",
        str(tmp_path / "cpu"), "--csv", str(tmp_path / "cpu.csv")]))
    for pipeline in ("pallas", "list"):
        assert abs(images[pipeline] - images["mega"]).max() <= 1e-4
    # the card's generator (Philox) and the CPU's (Mersenne Twister) jitter
    # the camera rays apart: the frames agree in their means
    assert abs(float(cpu.image.mean()) - float(images["mega"].mean())) <= 0.01
    hit = (images["mega"][..., 0] > images["mega"][..., 1]).mean()
    assert hit > 0.1
    assert abs((cpu.image[..., 0] > cpu.image[..., 1]).mean() - hit) <= 0.02


# ---------------------------------------------------------------------------
# mega_path: the path integrator's persistent warps that refill finished
# lanes (K1, and K7, K8 and K9 on the same loop)
# ---------------------------------------------------------------------------

REFILL_SIZES = (1, 31, 33, 4097, (1 << 18) + 7)


def _refill_frame(kind, dev):
    """(scene, camera, cfg, want_winners) of a frame whose path launches run
    the mega_path instance of kernel mode ``kind``."""
    if kind == "K8":
        scene, cam, cfg = _frame("light_box", dev)
        return scene, cam, cfg, False
    if kind == "K9":
        scene, cam, cfg, _ = _tex_frame("tex_spheres_fixed", dev)
        return scene, cam, cfg, False
    scene, cam, cfg = _frame("random_spheres", dev)
    return scene, cam, cfg, kind == "K7"


def _n_rays(cam, cfg, dev, n):
    """The frame's first n rays in swizzled order (two launches' worth)."""
    a, b = (_first_launch(cam, cfg, dev, 31, k) for k in (0, 1))
    return type(a)(*(torch.cat([x, y])[:n].contiguous() for x, y in zip(a, b)))


# A 32-bit word that is a NaN as float32 and, as int32, a winner the kernel
# never writes (below -1)
FILL = -4194297                                        # 0xffc00007


def _freed_filled(numels, dev, k=3):
    """Frees k blocks of each element count in ``numels`` (int32), filled
    with FILL, each between two live blocks of its size so that it merges
    with no neighbour: the caching allocator hands them to the current
    stream's next requests of those sizes (best fit).  -> (the live blocks,
    to keep until those requests are made; the freed blocks' addresses)."""
    live, fills = [], []
    for numel in numels:
        live.append(torch.empty(numel, dtype=torch.int32, device=dev))
        for _ in range(k):
            fills.append(torch.full((numel,), FILL, dtype=torch.int32,
                                    device=dev))
            live.append(torch.empty(numel, dtype=torch.int32, device=dev))
    freed = {x.data_ptr() for x in fills}
    fills.clear()
    return live, freed


def _refill_launch(tables, rays, cfg, want_winners, seed, stream):
    """One launch on ``stream`` into outputs that the caching allocator
    hands over pre-filled with FILL (NaN, and a winner the kernel never
    writes); -> (radiance, winners or None)."""
    n = rays.origin.shape[0]
    numels = [3 * n] + ([(DEPTH + 1) * n] if want_winners else [])
    with torch.cuda.stream(stream):
        live, freed = _freed_filled(numels, rays.origin.device)
        got = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None,
                              seed, want_winners=want_winners)
        del live
    got, win = got if want_winners else (got, None)
    assert got.data_ptr() in freed
    assert win is None or win.data_ptr() in freed
    torch.cuda.current_stream().wait_stream(stream)
    return got, win


def _refill_stream(dev):
    """A side stream that holds no cached blocks and sees the rays."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream())
    return stream


@pytest.mark.gpu
@pytest.mark.parametrize("n", REFILL_SIZES)
@pytest.mark.parametrize("kind", ["K1", "K7", "K8", "K9"])
def test_refill_edges_match_plain(cuda, kind, n):
    """n rays on the persistent warps: every row of the radiance (and of
    the winners, trailing -1s included) written and equal to the plain
    version's; a second launch on the same stream gives the same outputs
    (the counter starts from 0 again); the grid holds the blocks the card
    holds at once, no more than the rays need."""
    scene, cam, cfg, want_winners = _refill_frame(kind, cuda)
    rays = _n_rays(cam, cfg, cuda, n)
    tables = mk.morton_tables(scene)
    stream = _refill_stream(cuda)
    got, win = _refill_launch(tables, rays, cfg, want_winners, 13, stream)
    info = mk.path_instance(n, cuda, xform=kind == "K8",
                            winners=want_winners, tex=kind == "K9")
    assert 0 < info["grid_blocks"] == min(
        info["blocks_per_sm"] * info["sms"], -(-n // info["block"]))
    ref = mk.trace_path_mega_plain(tables, rays, cfg, None, 13,
                                   want_winners=want_winners)
    if want_winners:
        ref, wref = ref
        assert torch.equal(win, wref)
    if kind == "K9":
        _assert_texels_match(got, ref)
    else:
        _assert_rays_match(got, ref)
    again, win_again = _refill_launch(tables, rays, cfg, want_winners, 13,
                                      stream)
    assert torch.equal(again, got)
    if want_winners:
        assert torch.equal(win_again, win)


@pytest.mark.gpu
@pytest.mark.parametrize("n_grid", [22, 40])
def test_refill_counting_instance_counts_the_schedule(cuda, n_grid):
    """random_spheres' 484 spheres (one box level) and 1,600 (40 x 40,
    two levels): the persistent warps equal the plain version, and the
    counting instance renders the same and counts the schedule it ran:
    every ray's bounces, at most 32 a warp step, fewer draws."""
    scene, cam = presets.random_spheres(16 / 9, n=n_grid, device=cuda)
    cfg = RenderConfig(width=512, height=256, samples=2, max_depth=DEPTH,
                       engine="mega")
    rays = generate_pixel_rays(
        cam, 512, 256, 2,
        generator=torch.Generator(device=cuda).manual_seed(3))
    tables = mk.morton_tables(scene)
    got, _ = _refill_launch(tables, rays, cfg, False, 29,
                            _refill_stream(cuda))
    assert mk.path_instance(rays.origin.shape[0], cuda)["refill_idle"] > 0
    _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, cfg, None,
                                                     29))
    counts = torch.zeros(mk.N_COUNTS, dtype=torch.int64, device=cuda)
    work = torch.zeros(mk.N_WORK, dtype=torch.int64, device=cuda)
    counted = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None,
                              29, counts=counts, work=work)
    assert torch.equal(counted, got)
    bounces, warp_steps, draws = work.tolist()
    n = rays.origin.shape[0]
    assert n <= bounces <= (DEPTH + 1) * n
    assert bounces <= 32 * warp_steps and 0 < draws < bounces


# ---------------------------------------------------------------------------
# The fused tables' margins, K8's culled walk and K7's fill
# ---------------------------------------------------------------------------

def _stress_rays(case, dev):
    """(scene, tables, origins, directions, quirks) of a stress case: rays
    along the planes of the icosphere's exact chunk or super boxes, rays
    grazing 4,096 slivers, or rays tangent to spheres where they touch
    their boxes (2^14 rays)."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    n = 1 << 14
    kind, arg, profile = case
    quirks = getattr(Quirks, profile)()
    if kind == "planes":
        scene, _ = cs.icosphere_scene(2.0, device=dev)
        tables = mk.morton_tables(scene)
        tr = scene.triangles
        rows = tables.tri_map.long()
        v0, v1, v2 = (x[rows] for x in (tr.v0, tr.v1, tr.v2))
        box = sw.group_boxes(torch.minimum(torch.minimum(v0, v1), v2),
                             torch.maximum(torch.maximum(v0, v1), v2), arg,
                             arg)
        o, d = cs.plane_rays(box.cpu().numpy(), tr.v0.mean(0).cpu().numpy(),
                             n, 5)
    elif kind == "slivers":
        v = cs.sliver_cylinder()
        b = SceneBuilder()
        mat = b.materials.lambertian(color=(0.5, 0.5, 0.5))
        pts = np.concatenate(v)
        b.add_mesh(pts, np.arange(len(pts)).reshape(3, -1).T, mat,
                   reverse_winding=False)
        scene = b.build(dev)
        tables = mk.morton_tables(scene)
        o, d = cs.grazing_rays(n, *arg, seed=11)
    else:
        scene = (presets.random_spheres(2.0, device=dev)[0]
                 if arg == "random_spheres"
                 else cs.fill_sphere_field(SceneBuilder()).build(dev))
        tables = mk.morton_tables(scene)
        sp = scene.spheres
        o, d = cs.tangent_rays(sp.center.cpu().numpy(),
                               sp.radius.cpu().numpy(), n, 7)
    return (scene, tables, torch.as_tensor(o, device=dev),
            torch.as_tensor(d, device=dev), quirks)


STRESS = [("planes", 16, "reference"), ("planes", 16, "fixed"),
          ("planes", 256, "fixed"), ("slivers", (1e-3, 1e-1), "reference"),
          ("slivers", (1e-6, 1e-3), "fixed"),
          ("tangent", "random_spheres", "reference"),
          ("tangent", "sphere_field", "reference")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", STRESS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_fused_margins_keep_every_covered_winner(cuda, case):
    """The fused kernel's first hit (the path at depth 0 with its winners,
    and lambert) on rays that stress the boxes' margins equals the plain
    version's wherever the plain winner is covered by the margins' proof
    (every sphere hit; a triangle hit with |a| >= TRI_WELL |d| |e1|
    |e2|); K3's culled instances lose no tangent hit."""
    from cudaraytracer_tpu_torch.core.rays import Rays
    scene, tables, o, d, quirks = _stress_rays(case, cuda)
    rays = Rays(o, d, o.new_zeros(0))
    cfg = RenderConfig(max_depth=0, quirks=quirks, engine="mega")
    _, win = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=1,
                                want_winners=True)
    _, wref = mk.trace_path_mega_plain(tables, rays, cfg, None, 1, True)
    win, wref = win[0].long(), wref[0].long()
    covered = torch.ones_like(wref, dtype=torch.bool)
    if scene.n_triangles:
        tr = scene.triangles
        k = wref.clamp(0, scene.n_triangles - 1)
        covered = sw.triangle_conditioned(d, tr.v1[k] - tr.v0[k],
                                          tr.v2[k] - tr.v0[k])
    assert not bool(((win != wref) & covered).any())
    lam = dataclasses.replace(cfg, integrator="lambert")
    got = mk.trace_path_mega(scene, rays, lam, tables=tables)
    ref = mk.trace_path_mega_plain(tables, rays, lam)
    assert not bool(((got != ref).any(1) & covered).any())
    if case[0] == "tangent":
        sp = scene.spheres
        tbl, box, sup = sw.sphere_table(sp.center, sp.radius)
        ref_h = sw.sphere_best_hit_plain(o, d, sp.center, sp.radius, T_MIN,
                                         T_MAX)
        for coop in (False, True):
            got_h = sw.launch_sphere_sweep(o, d, tbl, box, None, None, T_MIN,
                                           T_MAX, sup=sup, coop=coop)
            assert torch.equal(got_h[1], ref_h[1])


def _xform_sets(scene, cam, cfg, dev, n=1 << 13):
    sets = {"camera": _first_launch(cam, cfg, dev, 3)[:2]}
    for name, (o, d) in cs.xform_edge_rays(scene, n, 19).items():
        sets[name] = (torch.as_tensor(o, device=dev),
                      torch.as_tensor(d, device=dev))
    return {k: (o[:n].contiguous(), d[:n].contiguous())
            for k, (o, d) in sets.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["reference", "fixed"])
@pytest.mark.parametrize("copies", [1, 2])
def test_xform_cull_matches_plain_on_edge_rays(cuda, profile, copies):
    """K8's culled walk on 1,100 rows a class (one copy) and on 40 rows a
    class each copied once and walked copies first (two copies: exact ties
    across chunks in reverse row order), camera rays and every
    ``xform_edge_rays`` set: the three integrators on an injected stream
    and the path on in-kernel draws with its winners (K7) equal to the
    plain version's."""
    from cudaraytracer_tpu_torch.core.rays import Rays
    cfg = RenderConfig(width=640, height=360, samples=4, max_depth=4,
                       quirks=getattr(Quirks, profile)(), engine="mega")
    if copies == 1:
        scene, cam = cs.trs_field_scene(1100, 640 / 360, device=cuda)
        tables = mk.morton_tables(scene)
    else:
        scene, cam = cs.trs_duplicates_scene(40, 640 / 360, device=cuda)
        tables = mk.build_mega_tables(scene,
                                      xform_orders=cs.duplicate_orders(40))
    assert tables.rect_box.shape[0] > 1
    for name, (o, d) in _xform_sets(scene, cam, cfg, cuda).items():
        rays = Rays(o, d, o.new_zeros(0))
        n = o.shape[0]
        stream = stream_from_generator(
            torch.Generator(device=cuda).manual_seed(6), n, 4, cuda)
        st = mk.stream_tensor(stream, n, 5)
        for integrator in INTEGRATORS:
            c = dataclasses.replace(cfg, integrator=integrator)
            got = mk.trace_path_mega(scene, rays, c, tables=tables,
                                     samples=stream)
            _assert_rays_match(got, mk.trace_path_mega_plain(tables, rays, c,
                                                             st))
        got, win = mk.trace_path_mega(scene, rays, cfg, tables=tables,
                                      seed=8, want_winners=True)
        ref, wref = mk.trace_path_mega_plain(tables, rays, cfg, None, 8,
                                             True)
        _assert_rays_match(got, ref)
        assert torch.equal(win, wref), name


@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_xform_counting_instance_counts_the_culled_walk(cuda, profile):
    """On (i)'s rows, one bounce of camera rays: the counting instance
    makes the chunk and super tests and the row tests of the plain walk
    (``megakernel.xform_walk_plain``) exactly, so the kernel's cull takes
    the plain walk's decisions, and tests fewer rows than the brute
    force."""
    scene, cam = cs.trs_field_scene(1100, 640 / 360, device=cuda)
    cfg = RenderConfig(width=640, height=360, samples=4, max_depth=0,
                       quirks=getattr(Quirks, profile)(), engine="mega")
    tables = mk.morton_tables(scene)
    rays = _first_launch(cam, cfg, cuda, 4)
    counts = torch.zeros(mk.N_COUNTS, dtype=torch.int64, device=cuda)
    counted = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None,
                              9, counts=counts)
    plain = mk._launch_mega(tables, rays.origin, rays.direction, cfg, None, 9)
    assert torch.equal(counted, plain)
    c = dict(zip(mk.COUNT_NAMES, counts.tolist()))
    _, _, _, walk = mk.xform_walk_plain(tables, rays.origin, rays.direction,
                                        cfg)
    for k in ("xbox", "rect", "tsph", "ttri"):
        assert c[k] == walk[k], k
    assert 0 < c["rect"] + c["tsph"] + c["ttri"] < (
        3 * 1100 * rays.origin.shape[0] / 2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["K7", "K7+K8", "K7+K6"])
def test_winners_match_plain_on_every_instance(cuda, kind):
    """K7's winners, read from the rows' id columns (the scene ids of
    spheres and triangles in Morton tables), on the persistent warps (K7,
    and K7 with K8's cooperative culled walk) and on the cooperative
    instances above 8,192 triangles (K6): every entry, the -1s after each
    path's end included, equal to the plain version's."""
    if kind == "K7+K6":
        scene, tables, cfg, rays = _big_field_launch(cuda)
        rays = type(rays)(*(x[:1 << 12].contiguous() for x in rays))
    elif kind == "K7+K8":
        scene, cam = cs.trs_field_scene(1100, 640 / 360, device=cuda)
        cfg = RenderConfig(width=640, height=360, samples=4, max_depth=DEPTH,
                           quirks=Quirks.fixed(), engine="mega")
        tables = mk.morton_tables(scene)
        rays = _n_rays(cam, cfg, cuda, 1 << 14)
    else:
        scene, cam, cfg = _frame("random_spheres", cuda)
        tables = mk.morton_tables(scene)
        rays = _n_rays(cam, cfg, cuda, 1 << 16)
        assert not torch.equal(tables.sph_map, torch.arange(
            tables.sph_map.shape[0], device=cuda, dtype=torch.int32))
    _, win = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=17,
                                want_winners=True)
    _, wref = mk.trace_path_mega_plain(tables, rays, cfg, None, 17, True)
    assert torch.equal(win, wref)
    assert int(win.min()) == -1 and int(win.max()) >= 0


# ---------------------------------------------------------------------------
# The BVH traversal, crt_bvh_traverse (csrc/bvh.cu)
# ---------------------------------------------------------------------------

BVH_MODES = [(cull, back, clip, shrink) for cull in (False, True)
             for back in (False, True) for clip in (False, True)
             for shrink in (False, True)]


def _bvh_rays(tri, tree, n, seed):
    """n rays of each kind at the triangles ``tri``: from a camera-like
    spot, from points on the mesh in random directions (bounces), and
    axis-parallel rays on the tree's node planes (the slab's NaN)."""
    v0, v1, v2 = (x.cpu().numpy() for x in (tri.v0, tri.v1, tri.v2))
    rng = np.random.default_rng(seed)
    target = v0.mean(0)
    o = (rng.normal(scale=0.3, size=(n, 3)) + [0.0, 1.0, 3.0]).astype(
        np.float32)
    d = (target + rng.normal(scale=0.6, size=(n, 3)) - o).astype(np.float32)
    k = rng.integers(0, len(v0), n)
    w = rng.dirichlet([1.0, 1.0, 1.0], n)
    p = (w[:, :1] * v0[k] + w[:, 1:2] * v1[k] + w[:, 2:] * v2[k]).astype(
        np.float32)
    box = torch.cat([tree.bbox_min, tree.bbox_max,
                     tree.bbox_min.new_zeros(tree.n_nodes, 2)], 1)
    sets = [(o, d), (p, rng.normal(size=(n, 3)).astype(np.float32)),
            cs.plane_rays(box.cpu().numpy(), target, n, seed)]
    dev = tri.v0.device
    return [(torch.as_tensor(np.ascontiguousarray(a), device=dev),
             torch.as_tensor(np.ascontiguousarray(b), device=dev))
            for a, b in sets]


def _walks_equal(tree, tri, o, d, quirks, shrink, alive=None):
    rays = Rays(o, d, o.new_zeros(0))
    args = (tree, tri.v0, tri.v1, tri.v2, tri.normal, rays, 1e-3, sw.BIG,
            quirks, shrink, alive)
    got = bvhmod.traverse_bvh(*args)
    ref = bvhmod.traverse_bvh_plain(*args)
    assert torch.equal(got[1], ref[1])
    assert float((got[0] - ref[0]).abs().max()) == 0.0
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("mode", BVH_MODES, ids=lambda m: "cull%d-back%d-"
                         "noclip%d-shrink%d" % m)
def test_bvh_traversal_matches_plain(cuda, mode):
    """Every production instance against the plain version on the
    icosphere: ids equal, t max abs error 0, dead lanes missing, and the
    counting instance giving the same winners."""
    cull, back, clip, shrink = mode
    quirks = Quirks(triangle_back_culling=cull, triangle_backface_only=back,
                    triangle_no_t_clip=clip)
    scene, _ = cs.icosphere_scene(2.0, device=cuda)
    tri = scene.triangles
    tree = bvhmod.build_triangle_bvh(tri.v0, tri.v1, tri.v2, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    hits = 0
    for o, d in _bvh_rays(tri, tree, 1 << 13, 5):
        full = _walks_equal(tree, tri, o, d, quirks, shrink)
        hits += int((full[1] >= 0).sum())
        alive = torch.rand(o.shape[0], generator=gen, device=cuda) < 0.6
        part = _walks_equal(tree, tri, o, d, quirks, shrink, alive)
        assert torch.equal(part[1], torch.where(alive, full[1], -1))
        counts = bvhmod.BVHCounts(
            torch.zeros(2, o.shape[0], dtype=torch.int32, device=cuda),
            torch.zeros(tree.n_nodes, dtype=torch.uint8, device=cuda),
            torch.zeros(tri.v0.shape[0], dtype=torch.uint8, device=cuda))
        before = bvhmod.LAUNCHES["bvh_traverse"]
        counted = bvhmod.launch_bvh_traverse(
            tree, tri.v0, tri.v1, tri.v2, tri.normal, o, d, 1e-3, sw.BIG,
            quirks, shrink, counts=counts)
        assert bvhmod.LAUNCHES["bvh_traverse"] == before
        assert torch.equal(counted[1], full[1])
        assert torch.equal(counted[0], full[0])
        assert int(counts.ray_tests[0].min()) >= 1
        assert int(counts.node_seen.sum()) >= 1
    # back-culling keeps the faces whose winding faces the ray, and
    # backface-only those whose stored normal faces away: together, none
    assert hits > 1000 or (cull and back)


@pytest.mark.gpu
def test_bvh_refit_and_forest_on_the_card(cuda):
    """The card's refit equals the CPU's bit for bit; the bone forest of
    skinned_field walks as its plain version does on the card."""
    mesh = cs.skinned_field()
    dm = tmesh.device_mesh(mesh, cuda)
    v0, v1, v2 = tmesh.skin_frame(dm, 0)
    tree = bvhmod.build_triangle_bvh(v0, v1, v2, device=cuda)
    w0, w1, w2 = tmesh.skin_frame(dm, 7)
    got = bvhmod.refit_bvh(tree, w0, w1, w2)
    host = bvhmod.FlatBVH(*(tuple(x.cpu() for x in f) if isinstance(f, tuple)
                            else f.cpu() for f in tree))
    ref = bvhmod.refit_bvh(host, w0.cpu(), w1.cpu(), w2.cpu())
    assert torch.equal(got.bbox_min.cpu(), ref.bbox_min)
    assert torch.equal(got.bbox_max.cpu(), ref.bbox_max)
    forest = bb.build_bone_forest(*(x.cpu().numpy() for x in (v0, v1, v2)),
                                  mesh.weights, mesh.faces, device=cuda)
    assert forest.n_dropped == 0 and len(forest.root_bones) == 2
    fit = bvhmod.refit_bvh(forest.bvh, w0, w1, w2)
    tri = type("Tri", (), {"v0": w0, "v1": w1, "v2": w2,
                           "normal": tmesh.recompute_face_normals(
                               w0, w1, w2)})
    for o, d in _bvh_rays(tri, fit, 1 << 12, 9)[:2]:
        for quirks in (Quirks.reference(), Quirks.fixed()):
            _walks_equal(fit, tri, o, d, quirks, None)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["random_spheres", "mixed_fixed"])
def test_compacted_wavefront_bit_equal(cuda, name):
    """cfg.wavefront_compact on the card: the alive-first partition between
    bounces is a pure permutation, so the frame through the sweeps (K3, K4)
    equals the unpartitioned one bit for bit, under an injected stream and
    under K2's counter draws."""
    (scene, cam), quirks = _scene(name, cuda)
    cfg = RenderConfig(width=128, height=64, samples=4, max_depth=DEPTH,
                       quirks=quirks)
    ccfg = dataclasses.replace(cfg, wavefront_compact=True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    rays = generate_pixel_rays(cam, 128, 64, 4, swizzled_pixels(
        128, 64, device=cuda), generator=gen)
    stream = stream_from_generator(gen, rays.origin.shape[0], DEPTH, cuda)
    fn = sweep_intersector_pair(cfg)
    for inject in (True, False):
        def draws():
            return (dict(rays=rays, samples=stream) if inject else
                    dict(generator=torch.Generator(device=cuda).manual_seed(5)))

        a = render_image(scene, cam, cfg, intersect_fn=fn, **draws())
        b = render_image(scene, cam, ccfg, intersect_fn=fn, **draws())
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_two_gloo_ranks_render_and_fit_on_one_card(cuda):
    """Two ranks share the card through gloo: the dp = 2 render (the
    wavefront's K2-K5, and K1 under mega) equals the single-process render
    bit for bit under injection, and the dp = 2 fit step (overlapped and
    post-hoc) matches the single-process step."""
    from cudaraytracer_tpu_torch.parallel import checks
    from cudaraytracer_tpu_torch.parallel.mesh import choose_backend, spawn
    assert choose_backend(2, cuda) == (
        "nccl" if torch.cuda.device_count() >= 2 else "gloo")
    three = ("preset", "three_spheres", {"aspect": 2.0})
    cfg = dict(width=128, height=64, samples=2, max_depth=DEPTH)
    cases = [(f"render_{e}", "render", dict(
        scene=three, tp=1, inject=("seed", 4), cfg=dict(cfg, engine=e)))
        for e in ("wavefront", "mega")]
    cases.append(("fit", "fit_step", dict(
        scene=three, tp=1, names=("centers", "albedo"), inject=("seed", 6),
        cfg=dict(width=64, height=32, samples=2, max_depth=4,
                 gamma=False))))
    out = spawn(checks.run_cases, 2, (cases,), device=cuda)[0]
    for e in ("wavefront", "mega"):
        assert out[f"render_{e}"]["mesh"] == {"dp": 2, "tp": 1}
        np.testing.assert_array_equal(out[f"render_{e}"]["img"],
                                      out[f"render_{e}"]["single"])
    fit = out["fit"]
    for mode in ("overlapped", "posthoc"):
        np.testing.assert_allclose(fit[mode]["loss"], fit["single"]["loss"],
                                   rtol=1e-6)
        for a, b in zip(fit[mode]["params"], fit["single"]["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_spans_time_the_device_and_nest_the_cuda_backward(cuda):
    """The program's spans on the card: a fit step's forward, backward and
    bounces carry device ms once the caller has synchronised, and the
    bounces that the checkpoint recomputes on the autograd engine's worker
    thread sit under ``fit.backward``; a traced step launches the
    program's kernels as an untraced one does."""
    from cudaraytracer_tpu_torch.utils import profiling
    scene, cam = presets.three_spheres(aspect=2.0, device=cuda)
    cfg = RenderConfig(width=64, height=32, samples=2, max_depth=4,
                       gamma=False)
    target = torch.rand(cfg.width * cfg.height, 3, device=cuda)
    params = {"albedo": (scene.textures.color0 * 0.6 + 0.1)
              .requires_grad_(),
              "centers": (scene.spheres.center + 0.05).requires_grad_()}
    step = train.make_fit_step(scene, cam, cfg, lr=0.1)

    def counted():
        before = {**mk.LAUNCHES, **sw.LAUNCHES}
        step(params, target, torch.Generator(device=cuda).manual_seed(1))
        return {k: v - before[k] for k, v in {**mk.LAUNCHES,
                                              **sw.LAUNCHES}.items()}

    untraced = counted()
    profiling.clear()
    profiling.enable()
    try:
        traced = counted()
    finally:
        profiling.disable()
    assert traced == untraced and untraced["scatter_draws"] == 1
    torch.cuda.synchronize()
    recs = {r["id"]: r for r in profiling.records()}
    profiling.clear()
    by_name = {}
    for r in recs.values():
        by_name.setdefault(r["name"], []).append(r)
    fwd, = by_name["fit.forward"]
    bwd, = by_name["fit.backward"]
    assert fwd["device_ms"] > 0.0 and bwd["device_ms"] > 0.0

    def under(r, top):
        while r["parent"] is not None:
            if r["parent"] == top["id"]:
                return True
            r = recs[r["parent"]]
        return False

    bounces = by_name["wavefront.bounce"]
    assert all(b["device_ms"] is not None for b in bounces)
    assert sum(under(b, fwd) for b in bounces) == cfg.max_depth + 1
    assert sum(under(b, bwd) for b in bounces) == cfg.max_depth + 1
