"""The plain reference on scenes small enough to check by hand, and its
draws, camera and tracer against the program's plain versions on the CPU
(the tests may import the program; the reference may not)."""

import math

import numpy as np
import pytest
import torch

from rtbench.inputs import one_weekend
from rtbench.reference import camera, philox, tracer

CFG = {"t_min": 1e-3, "t_max": 3.4028235e38, "max_depth": 8,
       "integrator": "path", "samples": 1}


def one_sphere(kind=tracer.LAMBERTIAN, colour=(0.5, 0.25, 1.0)):
    return {"tex_kind": np.array([0], np.int32),
            "tex_c0": np.array([colour], np.float32),
            "tex_c1": np.zeros((1, 3), np.float32),
            "mat_kind": np.array([kind], np.int32),
            "mat_tex": np.array([0], np.int32),
            "mat_albedo": np.array([colour], np.float32),
            "mat_fuzz": np.array([0.0], np.float32),
            "mat_ref_idx": np.array([1.5], np.float32),
            "center": np.array([[0.0, 0.0, -3.0]], np.float32),
            "radius": np.array([1.0], np.float32),
            "sph_mat": np.array([0], np.int32)}


def test_a_ray_at_a_sphere_hits_its_near_side():
    pr = tracer.sphere_prims(one_sphere(), "cpu")
    o = torch.zeros(2, 3)
    d = torch.tensor([[0.0, 0.0, -2.0], [0.0, 1.0, 0.0]])
    h = tracer.closest_hit(pr, o, d, CFG)
    assert h.hit.tolist() == [True, False]
    assert h.t[0].item() == pytest.approx(1.0)          # |d| = 2
    assert h.n[0].tolist() == pytest.approx([0.0, 0.0, 1.0])


def test_lambert_by_hand():
    """A head-on hit: attenuation x (d . n) x sky(d) x 0.2, with d
    unnormalised; a miss is the sky."""
    pr = tracer.sphere_prims(one_sphere(), "cpu")
    o = torch.zeros(2, 3)
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    out = tracer.lambert_radiance(pr, o, d, CFG)
    sky_mid = torch.tensor([0.75, 0.85, 1.0])   # t = 0.5
    # d . n = (0, 0, -1) . (0, 0, 1) < 0: clamped to 0
    assert out[0].tolist() == pytest.approx([0.0, 0.0, 0.0])
    assert out[1].tolist() == pytest.approx([0.5, 0.7, 1.0])
    inside = torch.tensor([[0.0, 0.0, -3.0]])
    out = tracer.lambert_radiance(pr, inside, torch.tensor([[0.0, 0.0,
                                                              -1.0]]), CFG)
    # from the centre the far root hits at z = -4, n = (0, 0, -1): d.n = 1
    assert out[0].tolist() == pytest.approx(
        (torch.tensor([0.5, 0.25, 1.0]) * sky_mid * 0.2).tolist())


def test_backface_only_and_no_t_clip():
    """triangle.h's quirks: a triangle facing the ray is missed, one facing
    away is hit, behind the origin too."""
    v0 = torch.tensor([[-1.0, -1.0, -2.0]])
    v1 = torch.tensor([[1.0, -1.0, -2.0]])
    v2 = torch.tensor([[0.0, 1.0, -2.0]])
    row = torch.tensor([0.0, 0.0, 1.0, 0.5, 0.5, 0.5, 0.0, 0.0, 0.0])
    o = torch.zeros(1, 3)
    for nz, hit in ((1.0, False), (-1.0, True)):
        pr = tracer.triangle_prims(v0, v1, v2, torch.tensor([[0.0, 0.0, nz]]),
                                   row)
        h = tracer.closest_hit(pr, o, torch.tensor([[0.0, 0.0, -1.0]]), CFG)
        assert bool(h.hit[0]) == hit
    pr = tracer.triangle_prims(v0, v1, v2, torch.tensor([[0.0, 0.0, 1.0]]),
                               row)
    h = tracer.closest_hit(pr, o, torch.tensor([[0.0, 0.0, 1.0]]), CFG)
    assert bool(h.hit[0]) and h.t[0].item() == pytest.approx(-2.0)


def test_path_absorbed_at_depth_zero_is_the_ambient():
    """A ray that hits and may not scatter (depth 0) returns 0.1."""
    pr = tracer.sphere_prims(one_sphere(), "cpu")
    cfg = dict(CFG, max_depth=0)
    out = tracer.path_radiance(pr, torch.zeros(1, 3),
                               torch.tensor([[0.0, 0.0, -1.0]]),
                               torch.zeros(1, dtype=torch.int64),
                               torch.zeros(1, dtype=torch.int64), cfg)
    assert out[0].tolist() == pytest.approx([0.1, 0.1, 0.1])


def test_finish_is_mean_gamma_clip():
    c = torch.tensor([[0.25, 0.0, 4.0], [0.25, -1.0, 0.0]])
    assert tracer.finish(c, 2)[0].tolist() == pytest.approx([0.5, 0.0, 1.0])


def test_draws_match_the_programs_philox():
    from cudaraytracer_tpu_torch.core import rng
    idx = torch.arange(1000)
    for seed in (0, 12345, 2 ** 61 + 7):
        a = philox.counter_draws(seed, idx, 3)
        b = rng.counter_draws(seed, idx, 3)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    seeds = torch.full((1000,), 2 ** 40 + 9, dtype=torch.int64)
    assert torch.equal(philox.counter_draws(seeds, idx, 1)[0],
                       rng.counter_draws(2 ** 40 + 9, idx, 1)[0])


def test_camera_rays_match_the_renderers():
    """replay_rays gives the rays that render_pixels draws, chunk seeds
    included."""
    from cudaraytracer_tpu_torch.core.camera import (generate_pixel_rays,
                                                     make_camera)
    p = one_weekend.camera_params(2.0)
    cam = camera.make_camera(p, "cpu")
    w, h, spp, chunk = 16, 8, 3, 30
    order = camera.swizzled_pixels(w, h, "cpu")
    picks = torch.tensor([0, 5, 11, 40, 127])
    g = torch.Generator().manual_seed(4)
    got = camera.replay_rays(cam, w, h, spp, chunk, g, order, picks, True)
    pcam = make_camera(p["lookfrom"], p["lookat"], p["vup"], p["vfov"],
                       p["aspect"], p["aperture"], p["focus_dist"],
                       device="cpu")
    g = torch.Generator().manual_seed(4)
    step = chunk // spp
    n_chunks = math.ceil(w * h / step)
    seeds = torch.randint(0, 2 ** 62, (n_chunks,), generator=g).tolist()
    rays = [generate_pixel_rays(pcam, w, h, spp, order[lo:lo + step],
                                generator=g) for lo in range(0, w * h, step)]
    o = torch.cat([r.origin for r in rays])
    d = torch.cat([r.direction for r in rays])
    ray_ids = (picks[:, None] * spp + torch.arange(spp)).reshape(-1)
    assert torch.equal(got.origin, o[ray_ids])
    assert torch.equal(got.direction, d[ray_ids])
    assert got.seed.tolist() == [seeds[int(p) // step] for p in picks
                                 for _ in range(spp)]
    assert got.index.tolist() == [(int(p) % step) * spp + s for p in picks
                                  for s in range(spp)]


def test_the_path_tracer_matches_the_programs_plain_kernel():
    """On the One Weekend scene the reference and the program's plain
    fused kernel agree bit for bit."""
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from rtbench.drivers import _common
    a = one_weekend.scene_arrays(3)
    scene = _common.program_scene(a, "cpu")
    g = torch.Generator().manual_seed(0)
    o = torch.tensor([13.0, 2.0, 3.0]).expand(512, 3).contiguous()
    d = (torch.rand(512, 3, generator=g) - 0.5) * 0.4 - o / 13.0
    cfg = _common.render_config({**CFG, "width": 1, "height": 1,
                                 "samples": 1, "gamma": True, "clip": True,
                                 "ray_chunk": 512, "engine": "mega",
                                 "quirks": "reference"})
    want = mk.trace_path_mega_plain(mk.build_mega_tables(scene),
                                    Rays(o, d, o.new_zeros(0)), cfg,
                                    seed=77)
    pr = tracer.sphere_prims(a, "cpu")
    got = tracer.path_radiance(pr, o, d, torch.full((512,), 77),
                               torch.arange(512), CFG)
    assert torch.equal(got, want)


def test_the_inputs_repeat_for_a_seed_and_keep_the_work():
    a, b, c = (one_weekend.scene_arrays(s) for s in (5, 5, 2 ** 62 + 1))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    for k in ("center", "radius", "mat_kind", "sph_mat"):
        assert np.array_equal(a[k], c[k])       # the layout is fixed
    assert not np.array_equal(a["tex_c0"], c["tex_c0"])
    assert a["center"].shape == (484, 3)
