"""cfg.wavefront_compact on the CPU: the alive-first partition between the
wavefront's bounces (``integrators.partition_alive_first``) is a pure
permutation.

  * against JAX's compacted ``trace_path`` under the same
    ``stream_from_key`` stream, brute force both sides: atol 2e-4, rtol
    1e-4 (tests/test_torch_wavefront.py's radiance band: XLA contracts
    FMAs on the CPU);
  * the port compacted against the port uncompacted, with brute force and
    with the sweeps' plain versions, on three_spheres and on a scene of
    spheres, triangles, a rect and TRS prims: bit-equal radiance under an
    injected stream and under the counter draws of a seed (the draws are
    gathered through the index whatever their source);
  * gradients (centers, radii, albedo): within 1e-6 of the
    largest entry (the scatter-adds into the parameters sum in another
    order);
  * a recording run (return_winners) and a replay (winners=) keep the
    original order: equal to the uncompacted runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core.rays import Rays as JRays
from cudaraytracer_tpu.models import presets as jpresets
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu_torch.config import RenderConfig, check_supported
from cudaraytracer_tpu_torch.core import camera as tcam
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import render as trender
from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                   scene_from_numpy)
from _torch_threads import one_intra_op_thread  # noqa: F401

W, H, SPP, DEPTH = 32, 16, 2, 8


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**kw):
    cfg = RenderConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                       gamma=False, **kw)
    return cfg, dataclasses.replace(cfg, wavefront_compact=True)


def _scene(name):
    if name == "three_spheres":
        return tpresets.three_spheres(aspect=2.0, device="cpu")
    from test_megakernel import _mixed_scene
    s, c = _mixed_scene()
    return scene_from_numpy(_np_tree(s), "cpu"), camera_from_numpy(
        _np_tree(c), "cpu")


def _frame(scene, cam, seed=0):
    rays = tcam.generate_pixel_rays(
        cam, W, H, SPP, generator=torch.Generator().manual_seed(seed))
    n = rays.origin.shape[0]
    return rays, tinteg.stream_from_generator(
        torch.Generator().manual_seed(seed + 1), n, DEPTH)


def test_config_admits_compaction_partition_is_stable():
    check_supported(_cfgs()[1])
    alive = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.bool)
    order = tinteg.partition_alive_first(alive)
    assert order.tolist() == [1, 2, 4, 7, 0, 3, 5, 6]


def test_compacted_trace_matches_jax():
    js, jc = jpresets.three_spheres(aspect=2.0)
    ts = scene_from_numpy(_np_tree(js), "cpu")
    tc = camera_from_numpy(_np_tree(jc), "cpu")
    rays = tcam.generate_pixel_rays(tc, W, H, SPP,
                                    generator=torch.Generator().manual_seed(3))
    o, d, t = (x.numpy() for x in rays)
    stream = jinteg.stream_from_key(jax.random.key(4), o.shape[0], DEPTH)
    jcfg = JConfig(width=W, height=H, samples=SPP, max_depth=DEPTH,
                   wavefront_compact=True)
    ref = np.asarray(jinteg.trace_path(
        js, JRays(*map(jnp.asarray, (o, d, t))), jax.random.key(4), jcfg,
        samples=stream))
    _, ccfg = _cfgs()
    got = tinteg.trace_path(ts, rays, ccfg, samples=tinteg.SampleStream(
        _t(stream.ball), _t(stream.prob)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("isect", ["brute", "sweeps"])
@pytest.mark.parametrize("name", ["three_spheres", "mixed"])
def test_compacted_trace_is_bit_equal(name, isect):
    scene, cam = _scene(name)
    cfg, ccfg = _cfgs()
    fn = trender.sweep_intersector_pair(cfg) if isect == "sweeps" else None
    rays, stream = _frame(scene, cam)
    for draws in (dict(samples=stream), dict(seed=11)):
        a = tinteg.trace_path(scene, rays, cfg, fn, **draws)
        b = tinteg.trace_path(scene, rays, ccfg, fn, **draws)
        assert torch.equal(a, b), (name, isect, list(draws))
        assert float(a.abs().max()) > 0.0
    # through the entry point too
    a = trender.render_image(scene, cam, cfg, rays=rays, samples=stream,
                             intersect_fn=fn)
    b = trender.render_image(scene, cam, ccfg, rays=rays, samples=stream,
                             intersect_fn=fn)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name,keys", [
    ("three_spheres", ("center", "color0")), ("mixed", ("center", "radius"))])
def test_compacted_gradients_match(name, keys):
    scene, cam = _scene(name)
    cfg, ccfg = _cfgs()
    rays, stream = _frame(scene, cam, 5)
    fn = trender.sweep_intersector_pair(cfg)
    where = {"center": "spheres", "radius": "spheres", "color0": "textures"}

    def grads(c):
        s, leaves = scene, []
        for k in keys:
            x = getattr(getattr(scene, where[k]), k).clone().requires_grad_()
            s = s._replace(**{where[k]: getattr(s, where[k])._replace(
                **{k: x})})
            leaves.append(x)
        loss = tinteg.trace_path(s, rays, c, fn, samples=stream).mean()
        return torch.autograd.grad(loss, leaves)

    for a, b in zip(grads(cfg), grads(ccfg)):
        scale = float(a.abs().max())
        assert scale > 0.0
        assert float((a - b).abs().max()) <= 1e-6 * scale


def test_recording_and_replay_keep_the_original_order():
    scene, cam = _scene("mixed")
    cfg, ccfg = _cfgs()
    rays, stream = _frame(scene, cam, 7)
    rad, win = tinteg.trace_path(scene, rays, cfg, samples=stream,
                                 return_winners=True)
    crad, cwin = tinteg.trace_path(scene, rays, ccfg, samples=stream,
                                   return_winners=True)
    assert torch.equal(rad, crad) and torch.equal(win, cwin)
    assert bool((win[1] >= 0).any()) and bool((win[1] < 0).any())
    rep = tinteg.trace_path(scene, rays, cfg, samples=stream, winners=win)
    crep = tinteg.trace_path(scene, rays, ccfg, samples=stream, winners=win)
    assert torch.equal(rep, crep)
