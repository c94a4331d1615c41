"""The port's parallel layer on the CPU: four gloo ranks, spawned once for
the module, run every rank-side case (``parallel/checks.py``) in one spawn,
and the tests hold their readings against the port's single process and
the JAX package (tests/test_parallel.py's cases, cut to the 40 s budget).

  * the tp closest hit (4 ranks, tp = 4) against JAX's intersect_scene_tp
    in shard_map on four of conftest's virtual CPU devices, on
    test_tp_intersection_exact's 37 spheres, 11 triangles and 64 rays
    rebuilt from the same seed: hit, prim and mat equal, t to rtol 1e-5,
    normal to 1e-4 (JAX's own tolerances); against the port's single
    process (the sweeps' plain versions, the same cull): equal;
  * dp x tp = 2 x 2 renders (normal and path, wavefront and mega, 32x16x2)
    on one injected stream: bit-equal to the port's single-process
    render_image; against JAX's single-device render_image on the same
    stream, atol 1e-3 (tests/test_torch_render.py's tolerance);
  * sample-parallel (2 x 2) against the mean of the members'
    single-process renders: 1e-6;
  * the fit step (2 x 2, wavefront and mega_diff): overlapped against
    post-hoc and sharded against single-process on the same frame, loss
    rtol 1e-6, params rtol 1e-5 and atol 1e-7 (tests/test_parallel.py
    :177-197); JAX's albedo-error decrease (:126-141) on 2 x 2 ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudaraytracer_tpu as crt
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core.rays import make_rays
from cudaraytracer_tpu.models import presets as jpresets
from cudaraytracer_tpu.ops import intersect as jisect
from cudaraytracer_tpu.parallel import intersect as jtpi
from cudaraytracer_tpu.parallel.mesh import make_mesh as jmake_mesh
from cudaraytracer_tpu.parallel.render import shard_scene as jshard_scene
from cudaraytracer_tpu_torch.config import RenderConfig
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.ops import render as trender
from cudaraytracer_tpu_torch.parallel import checks
from cudaraytracer_tpu_torch.parallel.mesh import (make_mesh,
                                                   pad_to_multiple, spawn)
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_torch_render import _jax_image_and_draws

W, H, SPP, DEPTH = 32, 16, 2, 8
RENDERS = [(i, e) for i in ("normal", "path") for e in ("wavefront", "mega")]
FITS = ("wavefront", "mega_diff")


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _tp_case():
    """test_tp_intersection_exact's scene and rays (tests/test_parallel.py
    :68-89), from the same seed."""
    rng = np.random.default_rng(0)
    b = crt.SceneBuilder()
    m = b.materials
    mats = [m.lambertian(color=rng.uniform(size=3)) for _ in range(4)]
    for i in range(37):
        b.add_sphere(rng.uniform(-3, 3, 3) + [0, 0, -8],
                     rng.uniform(0.2, 0.8), mats[i % 4])
    for i in range(11):
        c = rng.uniform(-2, 2, 3) + [0, 0, -5]
        b.add_triangle(c, c + rng.normal(scale=0.5, size=3),
                       c + rng.normal(scale=0.5, size=3), mats[i % 4])
    scene = b.build()
    o = np.zeros((64, 3), np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    return scene, o, d


@pytest.fixture(scope="module")
def jax_renders():
    """JAX's single-device frames (the wavefront, brute force) and the
    rays and stream they drew, per integrator."""
    js, jc = jpresets.three_spheres(aspect=2.0)
    out = {}
    for integ in ("normal", "path"):
        cfg = JConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                      integrator=integ)
        img, rays, stream = _jax_image_and_draws(js, jc, cfg,
                                                 jax.random.key(21))
        out[integ] = (img, tuple(np.asarray(x) for x in rays)
                      + (np.asarray(stream.ball), np.asarray(stream.prob)))
    return _np_tree(js), _np_tree(jc), out


@pytest.fixture(scope="module")
def ranks(jax_renders):
    """Rank 0's readings of every case, from one spawn of four gloo
    ranks."""
    js, jc, frames = jax_renders
    scene, o, d = _tp_case()
    three = ("preset", "three_spheres", {"aspect": 2.0})
    cases = [("mesh", "mesh_shapes", {}),
             ("tp", "tp_hits", dict(scene=("numpy", _np_tree(scene), None),
                                    origin=o, direction=d, tp=4,
                                    quirks="reference"))]
    for integ, engine in RENDERS:
        cases.append((f"render_{integ}_{engine}", "render", dict(
            scene=("numpy", js, jc), tp=2,
            cfg=dict(width=W, height=H, samples=SPP, max_depth=DEPTH,
                     integrator=integ, engine=engine, ray_chunk=1 << 20,
                     wavefront_sphere_cull="primary"),
            inject=("numpy", *frames[integ][1]))))
    cases.append(("sample_parallel", "sample_parallel", dict(
        scene=three, tp=2, seed=3,
        cfg=dict(width=W, height=H, samples=2, max_depth=4,
                 wavefront_sphere_cull="primary"))))
    for engine in FITS:
        cases.append((f"fit_{engine}", "fit_step", dict(
            scene=three, tp=2, names=("centers", "albedo"), lr=0.1,
            inject=("seed", 9),
            cfg=dict(width=W, height=H, samples=1, max_depth=4, gamma=False,
                     engine=engine))))
    # the single process's chunks sized to the ranks' tiles (W x H / 4)
    cases.append(("fit_aligned", "fit_step", dict(
        scene=three, tp=2, names=("centers", "albedo"), lr=0.1,
        inject=("seed", 9),
        cfg=dict(width=W, height=H, samples=1, max_depth=4, gamma=False,
                 ray_chunk=W * H // 4), grad_scale=True)))
    cases.append(("albedo", "albedo_fit", {"steps": 20}))
    return spawn(checks.run_cases, 4, (cases,), device="cpu", threads=1)[0]


def test_mesh_shapes_and_padding(ranks):
    assert ranks["mesh"] == {"tp2": {"dp": 2, "tp": 2},
                             "tp1": {"dp": 4, "tp": 1}, "rejects": True}
    with pytest.raises(AssertionError):
        make_mesh(6, tp=4)
    assert make_mesh(1).shape == {"dp": 1, "tp": 1}
    x = np.arange(10)
    y = pad_to_multiple(x, 4)
    assert y.shape == (12,) and (y[10:] == x[0]).all()
    assert pad_to_multiple(x, 5) is x
    np.testing.assert_array_equal(pad_to_multiple(x, 4, fill=0)[10:], 0)


def test_tp_closest_hit_matches_jax(ranks):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    scene, o, d = _tp_case()
    rays = make_rays(jnp.asarray(o), jnp.asarray(d))
    tp = 4
    mesh = jmake_mesh(4, tp=tp)
    padded, n_s, n_t = jshard_scene(scene, tp)

    def local(sph, tri, rest):
        sl = rest._replace(spheres=sph, triangles=tri)
        tp_i = jax.lax.axis_index("tp")
        return jtpi.intersect_scene_tp(
            sl, rays, "tp", tp_i * sph.radius.shape[0],
            tp_i * tri.mat.shape[0], 1e-3, 3.4e38, crt.Quirks.reference(),
            n_s, n_t)

    ref = jax.eval_shape(lambda: jisect.intersect_scene(scene, rays))
    want = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P("tp"), padded.spheres),
                  jax.tree.map(lambda _: P("tp"), padded.triangles),
                  jax.tree.map(lambda _: P(), padded)),
        out_specs=jax.tree.map(lambda _: P(), ref),
        check_vma=False))(padded.spheres, padded.triangles, padded)
    got = ranks["tp"]["tp"]
    hit = np.asarray(want.hit)
    assert hit.sum() > 0
    np.testing.assert_array_equal(got["hit"], hit)
    np.testing.assert_array_equal(got["prim"], np.asarray(want.prim))
    np.testing.assert_array_equal(got["mat"], np.asarray(want.mat))
    np.testing.assert_allclose(got["t"][hit], np.asarray(want.t)[hit],
                               rtol=1e-5)
    np.testing.assert_allclose(got["normal"][hit],
                               np.asarray(want.normal)[hit], rtol=1e-4,
                               atol=1e-4)
    for k, v in ranks["tp"]["single"].items():
        # a miss lane's point is o + BIG d in the single process, 0 here
        np.testing.assert_array_equal(got[k][hit] if k == "p" else got[k],
                                      v[hit] if k == "p" else v, err_msg=k)


@pytest.mark.parametrize("integ,engine", RENDERS)
def test_dp_tp_render_bit_equal_and_matches_jax(ranks, jax_renders, integ,
                                                engine):
    out = ranks[f"render_{integ}_{engine}"]
    assert out["mesh"] == {"dp": 2, "tp": 2}
    assert out["img"].shape == (H, W, 3)
    np.testing.assert_array_equal(out["img"], out["single"])
    np.testing.assert_allclose(out["img"], jax_renders[2][integ][0],
                               atol=1e-3)


def test_sample_parallel_matches_members_mean(ranks):
    out = ranks["sample_parallel"]
    assert np.isfinite(out["img"]).all()
    np.testing.assert_allclose(out["img"], out["ref"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("engine", FITS)
def test_fit_step_overlapped_posthoc_single(ranks, engine):
    out = ranks[f"fit_{engine}"]
    over, post, single = out["overlapped"], out["posthoc"], out["single"]
    for other in (post, single):
        np.testing.assert_allclose(over["loss"], other["loss"], rtol=1e-6)
        for a, b in zip(over["params"], other["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    # the step moved every parameter
    assert all(not np.array_equal(a, b) for a, b in
               zip(over["params"], checks._flat(checks._params(
                   tpresets.three_spheres(aspect=2.0, device="cpu")[0],
                   ("centers", "albedo")))))


def test_fit_step_chunk_aligned_within_regrouping(ranks):
    """With the single process's chunks sized to the ranks' tiles, both sum
    the same per-tile float32 gradients and differ only in the order in
    which they add the four tiles: the post-hoc step stays within that
    regrouping's derived bound of the single process
    (checks.regroup_limit), a bound of a few ulp of each parameter and
    far below the step itself; the overlapped step (its bounces' buckets
    regrouped too) within JAX's tolerances of the post-hoc one."""
    out = ranks["fit_aligned"]
    post, single = out["posthoc"], out["single"]
    np.testing.assert_allclose(post["loss"], single["loss"], rtol=1e-6)
    limits = checks.regroup_limit(out, "posthoc", "single", 0.1)
    for a, b, lim in zip(post["params"], single["params"], limits):
        assert (np.abs(a - b) <= lim).all(), (np.abs(a - b), lim)
    np.testing.assert_allclose(out["overlapped"]["loss"], post["loss"],
                               rtol=1e-6)
    for a, b in zip(out["overlapped"]["params"], post["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    for lim, p, q in zip(limits, out["start"], single["params"]):
        assert (lim <= 8 * np.spacing(np.abs(p))
                + 1e-3 * np.abs(p - q).max()).all()


def test_fit_decreases_albedo_error(ranks):
    out = ranks["albedo"]
    assert all(np.isfinite(out["losses"]))
    assert out["err1"] < out["err0"] * 0.8, out


def test_grad_sync_axes_needs_a_mesh():
    scene, cam = tpresets.three_spheres(device="cpu")
    cfg = RenderConfig(width=8, height=4, samples=1, max_depth=2,
                       grad_sync_axes=("dp", "tp"))
    with pytest.raises(ValueError, match="needs the mesh"):
        trender.render_image(scene, cam, cfg)
    with pytest.raises(ValueError, match="unknown axes"):
        trender.render_image(scene, cam, RenderConfig(
            width=8, height=4, samples=1, grad_sync_axes=("x",)))
    # a one-rank mesh made without a process group: the sync is the
    # identity, and the render equals the unsynced one
    a = trender.render_image(scene, cam, RenderConfig(
        width=8, height=4, samples=1, max_depth=2))
    b = trender.render_pixels(scene, cam, cfg, trender.swizzled_pixels(8, 4),
                              mesh=make_mesh(1))
    assert torch.equal(a.reshape(-1, 3)[trender.swizzled_pixels(8, 4)], b)
