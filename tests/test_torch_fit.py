"""The port's differentiable render and single-device fit on the CPU:
loss and gradients against ``jax.value_and_grad`` of the JAX package on
the same injected rays and stream, the sweep path against the port's
brute-force autograd, the SGD step, the checkpoint format shared with the
JAX package, and the fit CLI.

Sizes follow tests/test_fit_pallas_cpu.py: 24x16x1 rays, path depth 3.

Tolerances:
  * loss against JAX: rtol 1e-5 (one mean over a few hundred pixels of
    radiance that agrees to ~1e-6, see test_torch_wavefront.py);
  * gradients against JAX: rtol 1e-3, atol 1e-6.  Both packages run the
    same winner-only backward, but XLA contracts FMAs on the CPU and sums
    the scatter-adds in another order;
  * sweep path against brute force in the port: rtol 1e-4, atol 1e-6, as
    tests/test_fit_pallas_cpu.py holds JAX's pair to its brute force (the
    same estimator; the sweep backward recomputes t by the division form,
    the brute force differentiates the candidate's).
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
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import intersect as jisect
from cudaraytracer_tpu.ops import render as jrender
from cudaraytracer_tpu.parallel import train as jtrain
from cudaraytracer_tpu.utils import checkpoint as jckpt
from cudaraytracer_tpu_torch.apps import fit as fit_app
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core import camera as tcam
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import render as trender
from cudaraytracer_tpu_torch.parallel import checks
from cudaraytracer_tpu_torch.parallel import train as ttrain
from cudaraytracer_tpu_torch.parallel.mesh import spawn
from cudaraytracer_tpu_torch.utils import checkpoint as tckpt
from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                   params_from_numpy,
                                                   params_to_numpy,
                                                   scene_from_numpy, to_numpy)
from _torch_threads import one_intra_op_thread  # noqa: F401

W, H, SPP, DEPTH = 24, 16, 1, 3


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(js, jc, seed):
    """Rays from numpy jitter through the port's camera, JAX's stream."""
    tc = camera_from_numpy(_np_tree(jc), "cpu")
    rng = np.random.default_rng(seed)
    n = W * H * SPP
    rays = tcam.generate_pixel_rays(
        tc, W, H, SPP, jitter=_t(rng.uniform(size=(n, 2)).astype(np.float32)),
        disk=torch.zeros(n, 3), time_u=torch.zeros(n))
    o, d, t = (x.numpy() for x in rays)
    stream = jinteg.stream_from_key(jax.random.key(seed), n, DEPTH)
    return o, d, t, stream


def _tri_floor_scene():
    """Two spheres on a floor of two triangles whose normal points up, seen
    under fixed quirks: light scattered off the floor reaches the spheres,
    whose normals depend on where it left the floor, so the loss has a
    gradient on the floor's vertices (a checker texture or a path to the
    sky alone would give none)."""
    b = JSceneBuilder()
    m = b.materials
    floor = m.lambertian(color=(0.6, 0.6, 0.5))
    b.add_sphere((-0.6, 0.0, -3.0), 0.5, m.lambertian(color=(0.9, 0.2, 0.2)))
    b.add_sphere((0.6, 0.0, -3.0), 0.5, m.metal((0.8, 0.7, 0.3), fuzz=0.2))
    up = (0.0, 1.0, 0.0)
    b.add_triangle((-4, -0.5, 0), (4, -0.5, 0), (4, -0.5, -8), floor,
                   normal=up)
    b.add_triangle((-4, -0.5, 0), (4, -0.5, -8), (-4, -0.5, -8), floor,
                   normal=up)
    cam = jcam.make_camera((0, 0.5, 2), (0, 0, -3), vfov=45, aspect=1.5,
                           focus_dist=5.0)
    return b.build(), cam


def _start_params(js, rng):
    p = {"albedo": np.asarray(js.textures.color0) * 0.7 + 0.1,
         "centers": np.asarray(js.spheres.center) + 0.03}
    if js.n_triangles:
        tr = js.triangles
        p["tri_v"] = tuple(np.asarray(v) + rng.normal(
            scale=0.02, size=np.shape(v)).astype(np.float32)
            for v in (tr.v0, tr.v1, tr.v2))
    return {k: (tuple(x.astype(np.float32) for x in v) if isinstance(v, tuple)
                else v.astype(np.float32)) for k, v in p.items()}


def _jax_value_and_grad(js, o, d, t, stream, params, attrs, quirks):
    cfg = JConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                  gamma=False, wavefront_kernel_attrs=attrs, quirks=quirks)
    isect = jrender.pallas_intersector_pair(cfg)
    rays = JRays(*map(jnp.asarray, (o, d, t)))
    key = jax.random.key(0)
    target = jinteg.integrate(js, rays, key, cfg, isect, samples=stream)

    def loss(p):
        s = jtrain.apply_sphere_params(js, p)
        return jnp.mean((jinteg.integrate(s, rays, key, cfg, isect,
                                          samples=stream) - target) ** 2)

    jp = jax.tree.map(jnp.asarray, params)
    if attrs:
        jisect.CONSOLIDATE = True
    try:
        value, grads = jax.value_and_grad(loss)(jp)
    finally:
        if attrs:
            jisect.CONSOLIDATE = None
            jax.clear_caches()
    return float(value), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(ts, o, d, t, stream, params, attrs, quirks,
                         sweeps=True):
    cfg = RenderConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                       gamma=False, wavefront_kernel_attrs=attrs,
                       quirks=Quirks(**quirks.__dict__))
    isect = trender.sweep_intersector_pair(cfg) if sweeps else None
    rays = Rays(*map(_t, (o, d, t)))
    samples = tinteg.SampleStream(_t(stream.ball), _t(stream.prob))
    with torch.no_grad():
        target = tinteg.integrate(ts, rays, cfg, samples=samples,
                                  intersect_fn=isect)
    p = params_from_numpy(params, "cpu")
    loss = torch.mean((tinteg.integrate(
        ttrain.apply_sphere_params(ts, p), rays, cfg, samples=samples,
        intersect_fn=isect) - target) ** 2)
    leaves = ttrain._leaves(p)
    grads = ttrain._unflatten(p, torch.autograd.grad(loss, leaves))
    return float(loss.detach()), params_to_numpy(grads)


def _assert_grads_close(got, ref, rtol, atol):
    assert set(got) == set(ref)
    for k in ref:
        g, r = got[k], ref[k]
        for gi, ri in zip(g if isinstance(g, tuple) else (g,),
                          r if isinstance(r, tuple) else (r,)):
            assert np.abs(ri).max() > 0, k
            np.testing.assert_allclose(gi, ri, rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("scene", ["tri_floor", "three_spheres_attrs"])
def test_loss_and_gradients_match_jax(scene):
    """Albedo, centres and (triangle-floor scene) triangle vertices: the
    sweep pair (K3/K4, or K5 on the pure-sphere scene) against JAX's
    Pallas pair."""
    attrs = scene.endswith("attrs")
    js, jc = (jpresets.three_spheres(aspect=1.5) if attrs
              else _tri_floor_scene())
    quirks = JQuirks.reference() if attrs else JQuirks.fixed()
    o, d, t, stream = _inputs(js, jc, 3)
    params = _start_params(js, np.random.default_rng(1))
    ref_loss, ref_grads = _jax_value_and_grad(js, o, d, t, stream, params,
                                              attrs, quirks)
    ts = scene_from_numpy(_np_tree(js), "cpu")
    loss, grads = _port_value_and_grad(ts, o, d, t, stream, params, attrs,
                                       quirks)
    assert ref_loss > 0
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    _assert_grads_close(grads, ref_grads, rtol=1e-3, atol=1e-6)


def test_sweep_gradients_match_brute_force():
    js, jc = _tri_floor_scene()
    o, d, t, stream = _inputs(js, jc, 5)
    params = _start_params(js, np.random.default_rng(2))
    ts = scene_from_numpy(_np_tree(js), "cpu")
    q = JQuirks.fixed()
    loss_s, g_s = _port_value_and_grad(ts, o, d, t, stream, params, False, q)
    loss_b, g_b = _port_value_and_grad(ts, o, d, t, stream, params, False, q,
                                       sweeps=False)
    np.testing.assert_allclose(loss_s, loss_b, rtol=1e-6)
    _assert_grads_close(g_s, g_b, rtol=1e-4, atol=1e-6)


def test_fit_step_sweeps_match_brute_and_move_params():
    """make_fit_step through render_pixels (mean, no gamma): the sweep
    pair (K5 here, wavefront_kernel_attrs) against brute force, as
    tests/test_fit_pallas_cpu.py holds the JAX pair."""
    scene, cam = tpresets.three_spheres(aspect=1.5, device="cpu")
    cfg = RenderConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                       gamma=False, ray_chunk=1 << 20)
    target = trender.render_image(scene, cam, cfg)
    params = {"albedo": (scene.textures.color0 * 0.7 + 0.1).requires_grad_(),
              "centers": (scene.spheres.center + 0.03).requires_grad_()}
    out = []
    for sweeps in (True, False):
        step = ttrain.make_fit_step(scene, cam, cfg, lr=0.5,
                                    use_sweeps=sweeps)
        out.append(step(params, target.reshape(-1, 3),
                        torch.Generator().manual_seed(7)))
    (lp, pp), (lb, pb) = out
    assert np.isfinite(float(lp))
    np.testing.assert_allclose(float(lp), float(lb), rtol=1e-5, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(pp[k].detach(), pb[k].detach(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        assert pp[k].requires_grad and pp[k].is_leaf
    assert float((pp["albedo"] - params["albedo"]).detach().abs().max()) > 1e-7


def test_fit_lowers_the_loss_on_fixed_draws():
    """SGD with the same rays and draws every step (the shape of the
    bench's fit): the loss is finite and falls."""
    scene, cam = tpresets.three_spheres(aspect=1.5, device="cpu")
    cfg = RenderConfig(width=W, height=H, samples=2, max_depth=DEPTH,
                       gamma=False)
    pix = torch.arange(W * H)
    rays = tcam.generate_pixel_rays(cam, W, H, 2,
                                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        target = trender.render_pixels(
            scene, cam, cfg, pix, torch.Generator().manual_seed(2), rays=rays)
    params = params_from_numpy({
        "albedo": to_numpy(scene.textures.color0) * 0.6 + 0.1,
        "centers": to_numpy(scene.spheres.center) + 0.05}, "cpu")
    step = ttrain.make_fit_step(scene, cam, cfg, lr=0.5)
    losses = []
    for _ in range(4):
        loss, params = step(params, target, torch.Generator().manual_seed(2),
                            rays=rays)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_fit_rejects_unported_modes():
    scene, cam = tpresets.three_spheres(aspect=1.5, device="cpu")
    cfg = RenderConfig(width=8, height=4, samples=1)
    # dp = 2 is ported (ROADMAP item 20): make_fit_step(..., dp=2) makes its
    # mesh on a process group of two gloo ranks, and its step equals the
    # single-process step on the same frame
    out = spawn(checks.run_cases, 2, ([("fit", "fit_step", dict(
        scene=("preset", "three_spheres", {"aspect": 1.5}), tp=1,
        names=("albedo",), inject=("seed", 3), by_counts=True,
        cfg=dict(width=8, height=4, samples=1, max_depth=2,
                 gamma=False)))],), device="cpu", threads=1)[0]["fit"]
    assert out["mesh"] == {"dp": 2, "tp": 1}
    for mode in ("overlapped", "posthoc"):
        np.testing.assert_allclose(out[mode]["loss"], out["single"]["loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(out[mode]["params"][0],
                                   out["single"]["params"][0], rtol=1e-5,
                                   atol=1e-7)
    with pytest.raises(AssertionError, match="torch.distributed"):
        ttrain.make_fit_step(scene, cam, cfg, dp=2)
    # mega_mxu (K12) is ported: a mega_diff fit step under it runs (the
    # recording forward takes the Moller-Trumbore sweep, JAX :2609)
    step = ttrain.make_fit_step(scene, cam, dataclasses.replace(
        cfg, engine="mega_diff", mega_mxu=True, gamma=False), lr=0.5)
    params = {"albedo": (scene.textures.color0 * 0.7 + 0.1).requires_grad_()}
    loss, out = step(params, torch.zeros(cfg.width * cfg.height, 3),
                     torch.Generator().manual_seed(7))
    assert np.isfinite(float(loss))
    assert not torch.equal(out["albedo"], params["albedo"])
    with pytest.raises(ValueError, match="forward only"):
        ttrain.make_fit_step(scene, cam, dataclasses.replace(cfg,
                                                             engine="mega"))


def test_checkpoints_cross_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    params = {"centers": rng.normal(size=(4, 3)).astype(np.float32),
              "tri_v": tuple(rng.normal(size=(2, 3)).astype(np.float32)
                             for _ in range(3))}
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_params(jpath, jax.tree.map(jnp.asarray, params), 7,
                      extra={"lr": 0.5})
    got, step, extra = tckpt.load_params(jpath)
    assert step == 7 and extra == {"lr": 0.5}
    np.testing.assert_array_equal(got["centers"], params["centers"])
    for a, b in zip(got["tri_v"], params["tri_v"]):
        np.testing.assert_array_equal(a, b)
    tpath = str(tmp_path / "port.npz")
    tckpt.save_params(tpath, params_from_numpy(params, "cpu"), 9)
    back, step, _ = jckpt.load_params(tpath)
    assert step == 9
    np.testing.assert_array_equal(back["tri_v"][2], params["tri_v"][2])
    leaves = params_from_numpy(back, "cpu")
    assert leaves["centers"].requires_grad and leaves["centers"].is_leaf
    assert isinstance(leaves["tri_v"], tuple)


def test_fit_cli_runs_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--cpu", "--steps", "3", "--width", "16", "--height", "9",
            "--samples", "1", "--checkpoint-every", "2", "--out",
            str(tmp_path)]
    assert fit_app.main(args) == 0
    out = capsys.readouterr().out
    assert "loss:" in out and (tmp_path / "fitted.png").exists()
    _, step, _ = tckpt.load_params(str(tmp_path / "fit_ckpt.npz"))
    assert step == 3
    assert fit_app.main(args[:2] + ["4"] + args[3:] + ["--resume"]) == 0
    assert "resumed" in capsys.readouterr().out
    # --devices / --tp are ported (ROADMAP item 20): each run spawns two
    # gloo ranks, and rank 0 writes the PNGs and the checkpoint
    for extra in (["--devices", "2"], ["--engine", "mega_diff", "--tp", "2"]):
        out = tmp_path / extra[-2].strip("-")
        argv = args[:-1] + [str(out)] + extra
        assert fit_app.main(argv) == 0
        assert (out / "fitted.png").exists()
        _, step, _ = tckpt.load_params(str(out / "fit_ckpt.npz"))
        assert step == 3
