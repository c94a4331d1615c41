"""The replay backward of ``engine='mega_diff'`` in the port against the JAX
package on the CPU: winners recorded by the fused engine's plain version
(kernel mode K7) and by the wavefront, ``replay_hits`` and the replayed
radiance, and the gradients of ``trace_path_mega_diff`` (the counterparts
of tests/test_replay.py:61, 85, 160, 218, 298 and 327).

Scenes come from the JAX SceneBuilder (the JAX tests' mixed and TRS
scenes, three_spheres) through ``scene_from_numpy``; rays and the scatter
stream are made with numpy and injected into both packages.  The JAX
fused engine runs its ``_mega_kernel`` in interpret mode.

Tolerances:
  * winners: equal on every ray and bounce, except where XLA's FMA
    contraction on the CPU flips a grazing hit that PyTorch (no
    contraction) does not: at most 0.5% of (ray, bounce) entries;
  * replay against recording (both in the port): atol 1e-5, as
    tests/test_replay.py:58 holds;
  * radiance against JAX: atol 2e-4 on every ray but 0.5% (the same FMA
    difference over a few bounces);
  * gradients: each against its reference to 2e-4 of the reference's
    largest entry (tests/test_replay.py:157), or 1e-3 against JAX (the FMA
    difference, and the scatter-adds summed in another order);
  * float64 gradcheck of replay_hits: torch.autograd.gradcheck's defaults.
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
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.core import camera as jcam
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import megakernel as jmk
from cudaraytracer_tpu.parallel import train as jtrain
from cudaraytracer_tpu_torch.apps import fit as fit_app
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core import camera as tcam
from cudaraytracer_tpu_torch.core import rng as trng
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import intersect as tisect
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.ops.integrators import SampleStream
from cudaraytracer_tpu_torch.parallel import train as ttrain
from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                   params_from_numpy,
                                                   params_to_numpy,
                                                   scene_from_numpy)
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_megakernel import _mixed_scene
from test_replay import _trs_scene

W, H, SPP, DEPTH = 32, 16, 1, 4


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _inputs(jc, seed, w=W, h=H, spp=SPP, depth=DEPTH):
    """(rays numpy, ball, prob): numpy jitter through the port's camera and
    a numpy stream."""
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


def _cfgs(quirks, **kw):
    kw = dict(dict(width=W, height=H, samples=SPP, max_depth=DEPTH), **kw)
    return (JConfig(quirks=quirks, **kw),
            RenderConfig(quirks=Quirks(**quirks.__dict__), **kw))


def _assert_winners(got, ref, share=0.005):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.int32
    bad = int((got != ref).sum())
    assert bad <= share * ref.size, bad


def _assert_radiance(got, ref, atol=2e-4, share=0.005):
    diff = np.abs(np.asarray(got) - np.asarray(ref)).max(axis=1)
    assert np.isfinite(got).all()
    assert int((diff > atol).sum()) <= share * diff.shape[0], (
        int((diff > atol).sum()), float(diff.max()))


def _assert_grads(got, ref, rel, may_vanish=()):
    """Each gradient to ``rel`` of the reference's largest entry; those
    named in ``may_vanish`` may be zero, and then must be zero in both."""
    for k in ref:
        r, g = np.asarray(ref[k]), np.asarray(got[k])
        assert np.isfinite(g).all(), k
        scale = np.abs(r).max()
        if k in may_vanish and scale == 0:
            assert not g.any(), k
            continue
        assert scale > 0, k
        np.testing.assert_allclose(g / scale, r / scale, atol=rel,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Winners and replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_winners_match_jax_and_replay_reproduces_recording(profile):
    """The mixed scene (tests/test_replay.py:35, :61): the fused engine's
    winners through Morton tables and padding of both prim types, and the
    port wavefront's (whose sweeps permute the spheres), against JAX's
    wavefront recording; replaying them reproduces the recording."""
    js, jc = _mixed_scene()
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    jcfg, tcfg = _cfgs(getattr(JQuirks, profile)())
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 3))
    ref, wref = jinteg.trace_path(js, jr, jax.random.key(0), jcfg,
                                  samples=jst, return_winners=True)
    tables = tmk.build_mega_tables(ts, *tmk.mega_orders(tree))
    mega_cfg = dataclasses.replace(tcfg, engine="mega")
    rad, wmega = tmk.trace_path_mega(ts, tr, mega_cfg, tables=tables,
                                     samples=tst, want_winners=True)
    with torch.no_grad():
        wave, wwave = tinteg.trace_path(ts, tr, tcfg, samples=tst,
                                        return_winners=True)
        replay = tinteg.trace_path(ts, tr, tcfg, samples=tst,
                                   winners=wmega)
    _assert_winners(wmega.numpy(), wref)
    _assert_winners(wwave.numpy(), wref)
    w = wmega.numpy()
    assert w.min() == -1 and w.max() < ts.n_spheres + ts.n_triangles
    _assert_radiance(rad.numpy(), ref)
    np.testing.assert_allclose(replay.numpy(), wave.numpy(), atol=1e-5)
    # without the recording lanes beyond a miss stay -1
    assert torch.equal(torch.where(wmega[:-1] < 0, wmega[1:], -1),
                       torch.full_like(wmega[1:], -1))


def test_rect_winners_are_scene_ids():
    """A rect's winner id comes after the spheres and triangles
    (tests/test_replay.py:85)."""
    b = JSceneBuilder()
    m = b.materials
    b.add_sphere((0, -100.5, -3), 100.0, m.lambertian(color=(0.5, 0.5, 0.5)))
    b.add_rect(m.lambertian(color=(0.8, 0.2, 0.2)),
               position=(0.0, 0.5, -3.0), scale=(2.0, 2.0, 1.0))
    js = b.build()
    jc = jcam.make_camera((0, 0.5, 2), (0, 0.5, -3), vfov=40, aspect=2.0,
                          focus_dist=5.0)
    ts = scene_from_numpy(_np_tree(js), "cpu")
    jcfg, tcfg = _cfgs(JQuirks.reference(), max_depth=3)
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 4, depth=3))
    _, wref = jinteg.trace_path(js, jr, jax.random.key(0), jcfg, samples=jst,
                                return_winners=True)
    _, wmega = tmk.trace_path_mega(ts, tr, dataclasses.replace(
        tcfg, engine="mega"), samples=tst, want_winners=True)
    _assert_winners(wmega.numpy(), wref)
    assert (wmega == ts.n_spheres + ts.n_triangles).any()


@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_trs_winners_and_replay(profile):
    """Rect and TRS winners in the extended id space [... | t_spheres |
    t_triangles] (tests/test_replay.py:298); the replay through the
    TransformRay'd t reproduces the recording."""
    js, jc = _trs_scene()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    jcfg, tcfg = _cfgs(getattr(JQuirks, profile)())
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 5))
    ref, wref = jinteg.trace_path(js, jr, jax.random.key(0), jcfg,
                                  samples=jst, return_winners=True)
    rad, wmega = tmk.trace_path_mega(ts, tr, dataclasses.replace(
        tcfg, engine="mega"), tables=tmk.morton_tables(ts), samples=tst,
        want_winners=True)
    _assert_winners(wmega.numpy(), wref)
    _assert_radiance(rad.numpy(), ref)
    base = ts.n_spheres + ts.n_triangles + ts.n_rects
    assert (wmega == base).any() and (wmega == base + 1).any()
    with torch.no_grad():
        rec = tinteg.trace_path(ts, tr, tcfg, samples=tst)
        replay = tinteg.trace_path(ts, tr, tcfg, samples=tst, winners=wmega)
    np.testing.assert_allclose(replay.numpy(), rec.numpy(), atol=1e-5)


def _double(rec):
    if isinstance(rec, torch.Tensor):
        return rec.double() if rec.is_floating_point() else rec
    return type(rec)(*(_double(x) for x in rec))


def test_replay_hits_gradcheck():
    """replay_hits in float64 against finite differences, for sphere,
    triangle, rect, TRS-sphere and TRS-triangle winners (t, p, normal)."""
    b = JSceneBuilder()
    m = b.materials.lambertian(color=(0.5, 0.5, 0.5))
    b.add_sphere((-1.2, 0.0, -3.0), 0.5, m)
    b.add_triangle((0.2, -0.5, -3.0), (1.2, -0.5, -3.0), (0.7, 0.5, -3.0),
                   m)
    b.add_rect(m, position=(0.0, 0.8, -3.0), scale=(1.0, 1.0, 1.0))
    b.add_sphere((0.0, 0.0, -6.0), 0.4, m, rotation=(0, 0, 30),
                 scale=(1.0, 1.5, 1.0))
    b.add_triangle((-0.5, -0.5, 0.1), (0.5, -0.5, 0.2), (0, 0.5, 0.3), m,
                   position=(0.0, -1.6, -3.0), rotation=(0, 0, 15))
    scene32 = scene_from_numpy(_np_tree(b.build()), "cpu")
    scene = _double(scene32)
    tt = scene.t_triangles
    # the TRS triangle's centroid sits at R^T (q + position) in the world
    R = tmk.v3.rotation_matrix_euler_deg(tt.trs.rotation)[0].double()
    q = (tt.v0 + tt.v1 + tt.v2)[0] / 3.0 + tt.trs.position[0]
    d = torch.stack([torch.tensor([-1.2, 0.05, -3.0], dtype=torch.float64),
                     torch.tensor([0.7, -0.2, -3.0], dtype=torch.float64),
                     torch.tensor([0.1, 0.8, -3.0], dtype=torch.float64),
                     torch.tensor([0.02, 0.05, -1.0], dtype=torch.float64),
                     R.t() @ q])
    o = torch.zeros(5, 3, dtype=torch.float64)
    winner = tisect.intersect_scene(scene32, Rays(o.float(), d.float(),
                                                  torch.zeros(5)),
                                    quirks=Quirks.fixed()).prim
    assert winner.tolist() == [0, 1, 2, 3, 4], winner
    center = scene.spheres.center.clone().requires_grad_()
    tv1 = scene.triangles.v1.clone().requires_grad_()
    rect_pos = scene.rects.trs.position.clone().requires_grad_()
    radius = scene.t_spheres.radius.clone().requires_grad_()
    pos = tt.trs.position.clone().requires_grad_()
    v0 = tt.v0.clone().requires_grad_()

    def f(center, tv1, rect_pos, radius, pos, v0):
        s = scene._replace(
            spheres=scene.spheres._replace(center=center),
            triangles=scene.triangles._replace(v1=tv1),
            rects=scene.rects._replace(trs=scene.rects.trs._replace(
                position=rect_pos)),
            t_spheres=scene.t_spheres._replace(radius=radius),
            t_triangles=tt._replace(trs=tt.trs._replace(position=pos),
                                    v0=v0))
        h = tisect.replay_hits(s, Rays(o, d, torch.zeros(5,
                                                         dtype=o.dtype)),
                               winner, 1e-3, 1e30, Quirks.fixed())
        return h.t, h.p, h.normal

    assert torch.autograd.gradcheck(f, (center, tv1, rect_pos, radius, pos,
                                        v0))


# ---------------------------------------------------------------------------
# Gradients of mega_diff
# ---------------------------------------------------------------------------

def _mixed_params(scene):
    return {"centers": scene.spheres.center, "radius": scene.spheres.radius,
            "v0": scene.triangles.v0, "albedo": scene.textures.color0}


def _with_params(scene, p):
    return scene._replace(
        spheres=scene.spheres._replace(center=p["centers"],
                                       radius=p["radius"]),
        triangles=scene.triangles._replace(v0=p["v0"]),
        textures=scene.textures._replace(color0=p["albedo"]))


def _port_loss_grads(ts, tr, tst, cfg, wts, orders, params=None):
    p = params_from_numpy(params_to_numpy(_mixed_params(ts)) if params is None
                          else params, "cpu")
    s = _with_params(ts, p)
    tables = (tmk.build_mega_tables(s, *orders)
              if cfg.engine == "mega_diff" else None)
    out = tinteg.integrate(s, tr, cfg, tables=tables, samples=tst)
    loss = (out * wts).sum()
    grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(p, grads)}


@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_mega_diff_gradients_match_full_wavefront(profile):
    """tests/test_replay.py:160: the replay backward against the full
    wavefront (brute force) on the same stream, for albedo, centres, radii
    and triangle vertices.  The vertices' gradient is zero in both on these
    rays (JAX's wavefront gives zero on them too), structurally so under
    the reference quirks (a triangle-scattered ray self-hits at t ~ 0
    until the depth runs out)."""
    js, jc = _mixed_scene()
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    quirks = getattr(JQuirks, profile)()
    _, tcfg = _cfgs(quirks, max_depth=6)
    (_, _), (tr, tst) = _both(*_inputs(jc, 3, depth=6))
    wts = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(tr.origin.shape[0], 3)).astype(np.float32))
    orders = tmk.mega_orders(tree)
    lw, gw = _port_loss_grads(ts, tr, tst, tcfg, wts, orders)
    lm, gm = _port_loss_grads(ts, tr, tst, dataclasses.replace(
        tcfg, engine="mega_diff"), wts, orders)
    np.testing.assert_allclose(lm, lw, rtol=1e-4)
    _assert_grads(gm, gw, 2e-4, may_vanish=("v0",))


def test_mega_diff_flag_off_and_seed_route():
    """mega_replay_bwd=False (tests/test_replay.py:218) re-runs the full
    sweeps and gives the same gradients; without an injected stream both
    sides draw the counter-keyed numbers of one seed, the same as
    injecting those numbers."""
    js, jc = _mixed_scene()
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    _, tcfg = _cfgs(JQuirks.reference(), engine="mega_diff")
    (_, _), (tr, tst) = _both(*_inputs(jc, 6))
    n = tr.origin.shape[0]
    wts = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(n, 3)).astype(np.float32))
    orders = tmk.mega_orders(tree)
    _, g_on = _port_loss_grads(ts, tr, tst, tcfg, wts, orders)
    _, g_off = _port_loss_grads(ts, tr, tst, dataclasses.replace(
        tcfg, mega_replay_bwd=False), wts, orders)
    _assert_grads(g_off, g_on, 1e-5, may_vanish=("v0",))
    seed = 0x5EED
    draws = [trng.counter_draws(seed, torch.arange(n), s)
             for s in range(DEPTH + 1)]
    counter = SampleStream(torch.stack([b for b, _ in draws]),
                           torch.stack([p for _, p in draws]))
    _, g_inj = _port_loss_grads(ts, tr, counter, tcfg, wts, orders)
    p = params_from_numpy(params_to_numpy(_mixed_params(ts)), "cpu")
    s = _with_params(ts, p)
    out = tmk.trace_path_mega_diff(s, tr, tcfg,
                                   tables=tmk.build_mega_tables(s, *orders),
                                   seed=seed)
    grads = torch.autograd.grad((out * wts).sum(), list(p.values()))
    _assert_grads({k: g.numpy() for k, g in zip(p, grads)}, g_inj, 1e-6,
                  may_vanish=("v0",))


def test_mega_diff_gradients_match_jax():
    """Against jax.value_and_grad of the JAX trace_path_mega_diff (its
    kernel in interpret mode, the same injected stream) on the mixed scene
    under fixed quirks."""
    js, jc = _mixed_scene()
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    jcfg, tcfg = _cfgs(JQuirks.fixed(), engine="mega_diff")
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 7))
    wts = np.random.default_rng(3).uniform(
        size=(tr.origin.shape[0], 3)).astype(np.float32)
    orders = tmk.mega_orders(tree)

    def jloss(p):
        s = _with_params(js, p)
        out = jmk.trace_path_mega_diff(
            s, jr, jax.random.key(0), jcfg, samples=jst,
            tables=jmk.build_mega_tables(s, tri_order=orders[0],
                                         sph_order=orders[1]))
        return jnp.sum(out * wts)

    jv, jg = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in params_to_numpy(
            _mixed_params(ts)).items()})
    lv, lg = _port_loss_grads(ts, tr, tst, tcfg, torch.from_numpy(wts),
                              orders)
    np.testing.assert_allclose(lv, float(jv), rtol=1e-4)
    _assert_grads(lg, {k: np.asarray(v) for k, v in jg.items()}, 1e-3,
                  may_vanish=("v0",))


def test_mega_diff_trs_gradients_match_wavefront():
    """tests/test_replay.py:327: gradients with respect to a TRS position,
    a TRS radius and object-space vertices through the replay equal the
    wavefront's."""
    js, jc = _trs_scene()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    _, tcfg = _cfgs(JQuirks.reference())
    (_, _), (tr, tst) = _both(*_inputs(jc, 8))
    out = {}
    for engine in ("wavefront", "mega_diff"):
        pos = ts.t_spheres.trs.position.clone().requires_grad_()
        rad = ts.t_spheres.radius.clone().requires_grad_()
        tv0 = ts.t_triangles.v0.clone().requires_grad_()
        s = ts._replace(
            t_spheres=ts.t_spheres._replace(
                trs=ts.t_spheres.trs._replace(position=pos), radius=rad),
            t_triangles=ts.t_triangles._replace(v0=tv0))
        img = tinteg.integrate(s, tr, dataclasses.replace(tcfg,
                                                          engine=engine),
                               samples=tst)
        g = torch.autograd.grad(torch.mean(img ** 2), [pos, rad, tv0])
        out[engine] = {k: x.numpy() for k, x in zip(("pos", "rad", "v0"), g)}
    _assert_grads(out["mega_diff"], out["wavefront"], 3e-4)


def test_mega_diff_fit_steps_match_jax():
    """Three SGD steps of the mega_diff fit (make_fit_step: tables rebuilt
    from the params each step) on three_spheres at 32x16x2 against the JAX
    fit step's arithmetic (pixel loss through JAX trace_path_mega_diff,
    value_and_grad, p - lr g) on the same rays and stream, each step from
    the JAX step's params: the loss to rtol 1e-4 and the update to 5e-3 of
    its largest entry.  Measured: 4e-4, 1e-4 and 3.5e-3 of the centres'
    update at the three steps, with the same winners on every ray and
    bounce and radiance within 1.1e-5; at the third step's params each
    package's mega_diff agrees with its own wavefront to 8e-7, so the
    difference is the FMA rounding of a near-grazing ray, whose t gradient
    scales as 1 / sqrt(disc)."""
    js, jc = jpresets.three_spheres(aspect=2.0)
    ts = scene_from_numpy(_np_tree(js), "cpu")
    tc = camera_from_numpy(_np_tree(jc), "cpu")
    w, h, spp = 32, 16, 2
    jcfg, tcfg = _cfgs(JQuirks.reference(), width=w, height=h, samples=spp,
                       gamma=False, engine="mega_diff")
    (jr, jst), (tr, tst) = _both(*_inputs(jc, 9, w, h, spp))
    rng = np.random.default_rng(4)
    target = rng.uniform(0.2, 0.8, (w * h, 3)).astype(np.float32)
    p0 = {"albedo": np.asarray(js.textures.color0) * 0.7 + 0.1,
          "centers": np.asarray(js.spheres.center) + 0.03}
    p0 = {k: v.astype(np.float32) for k, v in p0.items()}
    lr = 0.5

    @jax.jit
    def jstep(p):
        def loss(p):
            s = jtrain.apply_sphere_params(js, p)
            cols = jinteg.integrate(s, jr, jax.random.key(0), jcfg,
                                    samples=jst)
            cols = jnp.clip(cols.reshape(w * h, spp, 3).mean(axis=1), 0, 1)
            return jnp.mean((cols - target) ** 2)

        v, g = jax.value_and_grad(loss)(p)
        return v, jax.tree.map(lambda a, b: a - lr * b, p, g)

    step = ttrain.make_fit_step(ts, tc, tcfg, lr=lr)
    start = p0
    for _ in range(3):
        jv, jp = jstep({k: jnp.asarray(v) for k, v in start.items()})
        tv, tp = step(params_from_numpy(start, "cpu"),
                      torch.from_numpy(target), rays=tr, samples=tst)
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-4)
        for k in p0:
            jd = np.asarray(jp[k]) - start[k]
            td = tp[k].detach().numpy() - start[k]
            assert np.abs(jd).max() > 0, k
            np.testing.assert_allclose(td / np.abs(jd).max(),
                                       jd / np.abs(jd).max(), atol=5e-3,
                                       err_msg=k)
        start = {k: np.asarray(v) for k, v in jp.items()}
    assert all(tp[k].is_leaf and tp[k].requires_grad for k in tp)


def test_fit_cli_mega_diff_on_cpu(tmp_path, capsys):
    args = ["--cpu", "--steps", "2", "--width", "16", "--height", "9",
            "--samples", "1", "--engine", "mega_diff", "--checkpoint-every",
            "0", "--out", str(tmp_path)]
    assert fit_app.main(args) == 0
    assert "loss:" in capsys.readouterr().out
    assert (tmp_path / "fitted.png").exists()
