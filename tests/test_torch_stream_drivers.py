"""The fused engine's compaction drivers on the CPU: the phased and compact
drivers (``trace_path_mega_phased``, ``trace_path_mega_compact``: kernel
mode K10's bounce windows) on the streamed terrain of
tests/test_torch_stream.py against the port's monolithic render, the
phased driver against the JAX package's (interpret mode) on a small
resident scene, and ``select_mega``'s routes (with K11's shells) against
JAX's.

Tolerances:
  * the drivers (phased, compact, routed) against the port's monolithic
    render: bit for bit (assert_array_equal), under injected and counter
    draws alike, since the draws are keyed by ray id;
  * the phased driver against JAX's on the mixed scene: atol 2e-4, rtol
    1e-4, as tests/test_torch_megakernel.py holds the fused engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import Quirks as JQuirks
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core.rays import make_rays as jmake_rays
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import megakernel as jmk
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core.rays import Rays
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.ops.integrators import SampleStream
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_torch_megakernel import _np_tree, _rays_np, _stream_np
from test_torch_stream import DEPTH, _cfg, _stream, _streamed, _trays
from test_megakernel import _mixed_scene


def _monolithic(ts, tables, rays, cfg, stream=None, seed=None):
    return tmk.trace_path_mega(ts, rays, cfg, tables=tables, samples=stream,
                               seed=seed)


@pytest.mark.parametrize("draws", ["injected", "counter"])
@pytest.mark.parametrize("every,octants,first", [
    (1, False, None), (2, False, None), (3, False, None),
    (1, True, None), (2, True, None), (3, True, None), (2, True, 1)])
def test_phased_equals_monolithic(every, octants, first, draws):
    """trace_path_mega_phased on the streamed terrain, every window length,
    with and without octant regrouping, and a first window of one bounce:
    bit-equal to the monolithic render, injected or counter draws."""
    _, ts, o, d, orders = _streamed("terrain")
    tables = tmk.build_mega_tables(ts, *orders)
    stream = _stream()[2] if draws == "injected" else None
    seed = None if stream is not None else 77
    cfg = _cfg()
    want = _monolithic(ts, tables, _trays(o, d), cfg, stream, seed)
    got = tmk.trace_path_mega_phased(ts, _trays(o, d), cfg, tables=tables,
                                     compact_every=every, samples=stream,
                                     seed=seed, octants=octants,
                                     first_window=first)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_phased_matches_jax_phased_on_a_resident_scene():
    """The port's phased driver and JAX's (interpret mode) on the mixed
    scene at 32x16x2, the same rays and injected stream."""
    js, jc = _mixed_scene()
    from cudaraytracer_tpu_torch.utils.convert import (camera_from_numpy,
                                                       scene_from_numpy)
    tree = _np_tree(js)
    ts = scene_from_numpy(tree, "cpu")
    tc = camera_from_numpy(_np_tree(jc), "cpu")
    o, d, t = _rays_np(tc, 3)
    n = o.shape[0]
    ball, prob = _stream_np(4, n)
    depth = ball.shape[0] - 1
    jcfg = JConfig(width=32, height=16, samples=2, max_depth=depth,
                   quirks=JQuirks.fixed(), engine="mega")
    ref = np.asarray(jmk.trace_path_mega_phased(
        js, jmake_rays(jnp.asarray(o), jnp.asarray(d)), jax.random.key(0),
        jcfg, compact_every=3,
        samples=jinteg.SampleStream(jnp.asarray(ball), jnp.asarray(prob)),
        octants=True))
    cfg = RenderConfig(width=32, height=16, samples=2, max_depth=depth,
                       quirks=Quirks.fixed(), engine="mega")
    got = tmk.trace_path_mega_phased(
        ts, Rays(*(torch.from_numpy(x) for x in (o, d, t))), cfg,
        tables=tmk.morton_tables(ts), compact_every=3,
        samples=SampleStream(torch.from_numpy(ball), torch.from_numpy(prob)),
        octants=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("draws", ["injected", "counter"])
@pytest.mark.parametrize("primary", [1, 2, DEPTH])
def test_compact_equals_monolithic(primary, draws):
    """trace_path_mega_compact (one Morton sort between two windows):
    bit-equal to the monolithic render."""
    _, ts, o, d, orders = _streamed("terrain")
    tables = tmk.build_mega_tables(ts, *orders)
    stream = _stream()[2] if draws == "injected" else None
    seed = None if stream is not None else 78
    want = _monolithic(ts, tables, _trays(o, d), _cfg(), stream, seed)
    got = tmk.trace_path_mega_compact(ts, _trays(o, d), _cfg(),
                                      tables=tables, primary_steps=primary,
                                      samples=stream, seed=seed)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("primary", [0, DEPTH + 1])
def test_compact_rejects_steps_outside_the_depth(primary):
    scene, cam = tpresets.three_spheres(device="cpu")
    rays = _trays(*cs.terrain_rays(4))
    with pytest.raises(ValueError, match=r"\[1, max_depth\]"):
        tmk.trace_path_mega_compact(scene, rays, _cfg(),
                                    primary_steps=primary, seed=1)


def _spy(monkeypatch):
    """Record the calls of trace_path_mega_phased (cfg, compact_every,
    octants) and let them run."""
    calls = []
    real = tmk.trace_path_mega_phased

    def spy(scene, rays, cfg, **kw):
        calls.append((cfg, kw["compact_every"], kw["octants"]))
        return real(scene, rays, cfg, **kw)

    monkeypatch.setattr(tmk, "trace_path_mega_phased", spy)
    return calls


@pytest.mark.parametrize("integrator", ["path", "lambert", "normal"])
def test_select_mega_routes_as_jax(monkeypatch, integrator):
    """With AUTO_COMPACT_TRIS lowered to 1 << 10 (as JAX's test lowers it),
    the terrain's path render takes the phased route (every 2 bounces,
    octants, 8 shells) and equals the monolithic render; lambert and normal
    stay monolithic; integrate(engine='mega') goes through select_mega."""
    _, ts, o, d, orders = _streamed("terrain")
    tables = tmk.build_mega_tables(ts, *orders)
    _, _, stream = _stream()
    cfg = _cfg(integrator=integrator)
    want = _monolithic(ts, tables, _trays(o, d), cfg, stream)
    monkeypatch.setattr(tmk, "AUTO_COMPACT_TRIS", 1 << 10)
    calls = _spy(monkeypatch)
    got = tinteg.integrate(ts, _trays(o, d), cfg, tables=tables,
                           samples=stream)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if integrator == "path":
        assert [(c.mega_f2b_shells, e, oc) for c, e, oc in calls] == [
            (8, 2, True)]
    else:
        assert calls == []


def test_select_mega_keeps_explicit_shells_and_small_scenes(monkeypatch):
    """An explicit mega_f2b_shells survives the automatic route; without
    the lowered threshold the 10k-triangle terrain runs monolithic, as it
    does with compact_auto off."""
    _, ts, o, d, orders = _streamed("terrain")
    tables = tmk.build_mega_tables(ts, *orders)
    calls = _spy(monkeypatch)
    for cfg in (_cfg(), _cfg(compact_auto=False)):
        tmk.select_mega(ts, _trays(o, d), cfg, tables=tables, seed=3)
    assert calls == []
    monkeypatch.setattr(tmk, "AUTO_COMPACT_TRIS", 1 << 10)
    tmk.select_mega(ts, _trays(o, d), _cfg(mega_f2b_shells=3),
                    tables=tables, seed=3)
    tmk.select_mega(ts, _trays(o, d), _cfg(compact_auto=False),
                    tables=tables, seed=3)
    assert [(c.mega_f2b_shells, e, oc) for c, e, oc in calls] == [
        (3, 2, True)]


def test_fused_drivers_reject_other_integrators():
    scene, _ = tpresets.three_spheres(device="cpu")
    rays = _trays(*cs.terrain_rays(4))
    with pytest.raises(ValueError, match="path integrator"):
        tmk.trace_path_mega_phased(scene, rays, _cfg(integrator="lambert"))
    with pytest.raises(ValueError, match="bounce window"):
        tmk.trace_path_mega(scene, rays, _cfg(integrator="normal"),
                            window=tmk.Window(0, 2, torch.empty(13, 4)))
