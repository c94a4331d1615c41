"""Scenes above the table-resident size on the CPU: the segment level
(kernel mode K6) of the port's fused engine against the JAX package, its
recorded winners (K7 on streamed tables), the field stand-ins' sizes, and
the mega_diff replay's discrete decisions.  The compaction drivers (K10's
windows, K11's shells on the routed path) are in
tests/test_torch_stream_drivers.py, the plain window over the planes, its
regrouping keys and the shell walk's model in
tests/test_torch_stream_windows.py; both take their scenes and helpers
from here.

The streamed scenes are tests/test_megakernel.py's: a 10,368-triangle
terrain (:202-230) and a 96 x 96 sphere field (:790-806), built by the same
fill functions in both packages, with 512 rays cast from above and an
injected scatter stream made with numpy.  Their renders are held against
the JAX package's brute-force ``integ.trace_path`` (its interpret-mode
fused drivers are too slow at this size).

Tolerances:
  * tables: equal to the JAX tables' boxes, rows and maps, exactly;
  * streamed renders against JAX ``trace_path``: atol 3e-4, rtol 1e-4, as
    tests/test_megakernel.py holds JAX's own engines;
  * winners against JAX's: equal on every ray and bounce;
  * the mega_diff replay against the plain version: rays bit for bit and
    no recorded winner missed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import Quirks as JQuirks
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core.rays import make_rays as jmake_rays
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import megakernel as jmk
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core.rays import Rays, make_rays
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.models import presets as tpresets
from cudaraytracer_tpu_torch.models.scene import SceneBuilder
from cudaraytracer_tpu_torch.ops import integrators as tinteg
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.ops import sweeps as tsw
from cudaraytracer_tpu_torch.ops.integrators import SampleStream
from cudaraytracer_tpu_torch.utils.convert import to_numpy
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_torch_megakernel import _np_tree, _rays_np, _stream_np

N_RAYS, DEPTH = 512, 4


def _build(fill):
    jb, tb = JSceneBuilder(), SceneBuilder()
    fill(jb)
    fill(tb)
    return jb.build(), tb.build("cpu")


_SCENES = {}


def _streamed(name):
    """(JAX scene, port scene, origins, directions, Morton orders (tri,
    sph)) of the terrain or the sphere field, built once per process."""
    if name not in _SCENES:
        if name == "terrain":
            js, ts = _build(cs.fill_terrain)
            o, d = cs.terrain_rays(N_RAYS)
        else:
            js, ts = _build(cs.fill_sphere_field)
            o, d = cs.sphere_field_rays(N_RAYS)
        _SCENES[name] = (js, ts, o, d, tmk.mega_orders(to_numpy(ts)))
    return _SCENES[name]


def _cfg(quirks="fixed", **kw):
    return RenderConfig(width=16, height=32, samples=1, max_depth=DEPTH,
                        quirks=getattr(Quirks, quirks)(), engine="mega", **kw)


def _stream(seed=5, n=N_RAYS):
    ball, prob = _stream_np(seed, n, DEPTH)
    return ball, prob, SampleStream(torch.from_numpy(ball),
                                    torch.from_numpy(prob))


def _trays(o, d):
    return make_rays(o, d, device="cpu")


@pytest.mark.parametrize("name", ["terrain", "sphere_field"])
def test_streamed_tables_match_jax(name):
    """Above 8,192 prims of a type: rows padded (repeat-last) to a SEG_T
    multiple, segment, super and chunk boxes equal to JAX's widened by the
    port's margins (SPH_MARGIN, TRI_MARGIN x each box's largest
    |coordinate|), the sphere super level forced on, equal row -> scene
    maps."""
    js, ts, _, _, (tri_o, sph_o) = _streamed(name)
    jt = _np_tree(jmk.build_mega_tables(js, tri_order=tri_o,
                                        sph_order=sph_o))
    tt = to_numpy(tmk.build_mega_tables(ts, tri_o, sph_o))
    kind = "tri" if name == "terrain" else "sph"
    rows, seg, sup, box = (getattr(tt, kind + s) for s in
                           ("", "_seg", "_super", "_box"))
    assert rows.shape[0] % tmk.SEG_T == 0 and rows.shape[0] > tmk.MAX_VMEM_PRIMS
    assert seg.shape == (rows.shape[0] // tmk.SEG_T, 8)
    assert sup.shape == (rows.shape[0] // tmk.SUPER_T, 8)
    margin = tsw.TRI_MARGIN if kind == "tri" else tsw.SPH_MARGIN
    for got, ref in ((seg, getattr(jt, kind + "_seg")),
                     (sup, getattr(jt, kind + "_super")),
                     (box, getattr(jt, kind + "_box"))):
        exact = torch.zeros(got.shape[0], 8)
        exact[:, :6] = torch.tensor(np.asarray(ref[:got.shape[0], :6]))
        np.testing.assert_array_equal(
            got[:, :6], tsw.widen_boxes(exact, margin).numpy()[:, :6])
        assert not got[:, 6:].any()
    width = 21 if kind == "tri" else 14
    np.testing.assert_array_equal(rows[:, :width], getattr(jt, kind)[:, :width])
    np.testing.assert_array_equal(getattr(tt, kind + "_map"),
                                  getattr(jt, kind + "_map"))
    other = "sph" if kind == "tri" else "tri"
    assert getattr(tt, other + "_seg").shape == (0, 8)
    assert tmk.table_bytes(tmk.build_mega_tables(ts, tri_o, sph_o)) == sum(
        x.nbytes for x in (tt.sph, tt.sph_box, tt.sph_super, tt.tri,
                           tt.tri_box, tt.tri_super, tt.rect, tt.tsph,
                           tt.ttri, tt.sph_seg, tt.tri_seg, tt.sph_map,
                           tt.tri_map))


@pytest.mark.parametrize("profile", ["fixed", "reference"])
@pytest.mark.parametrize("name", ["terrain", "sphere_field"])
def test_streamed_render_matches_jax_trace_path(name, profile):
    """The port's fused engine (plain version, Morton tables with the
    segment level) against JAX's brute-force wavefront on the same rays and
    injected stream."""
    js, ts, o, d, orders = _streamed(name)
    ball, prob, stream = _stream()
    jcfg = JConfig(width=16, height=32, samples=1, max_depth=DEPTH,
                   quirks=getattr(JQuirks, profile)())
    ref = np.asarray(jinteg.trace_path(
        js, jmake_rays(jnp.asarray(o), jnp.asarray(d)), jax.random.key(5),
        jcfg, samples=jinteg.SampleStream(jnp.asarray(ball),
                                          jnp.asarray(prob))))
    tables = tmk.build_mega_tables(ts, *orders)
    cfg = _cfg(profile)
    got = tmk.trace_path_mega(ts, _trays(o, d), cfg, tables=tables,
                              samples=stream).numpy()
    assert ref.mean() > 0.01
    if name == "terrain":
        np.testing.assert_allclose(got, ref, atol=3e-4, rtol=1e-4)
        return
    # The 0.11-radius spheres seen from 3 to 26 units: c = |oc|^2 - r^2
    # cancels (an ulp of |oc|^2 ~ 676 is 0.5% of r^2 = 0.0121), so any
    # other order of float32 operations moves the root, and the bounce
    # direction with it: 5 of these 512 rays differ from JAX by up to
    # 2.3e-3, the port's own wavefront as much.  Every ray is held to the
    # stated tolerance against the port's brute-force wavefront, and
    # against JAX all but 1%.  The witness for those rays is the same
    # wavefront in float64 (JAX's cannot run in float64: its scans carry
    # float32): JAX's float32 render misses the stated tolerance against
    # it there too, and the port is no farther from it than JAX.
    wcfg = dataclasses.replace(cfg, engine="wavefront")
    wave = tinteg.trace_path(ts, _trays(o, d), wcfg, samples=stream).numpy()
    np.testing.assert_allclose(got, wave, atol=3e-4, rtol=1e-4)
    off = ~np.isclose(got, ref, atol=3e-4, rtol=1e-4).all(axis=1)
    assert off.sum() <= N_RAYS // 100, int(off.sum())
    assert np.abs(got - ref).max() <= 3e-3
    if off.any():
        r = _trays(o, d)
        exact = tinteg.trace_path(
            _f64(ts), Rays(*(_f64(x) for x in r)), wcfg,
            samples=SampleStream(torch.from_numpy(ball).double(),
                                 torch.from_numpy(prob).double())).numpy()
        assert not np.isclose(ref[off], exact[off], atol=3e-4,
                              rtol=1e-4).all()
        assert (np.abs(got[off] - exact[off]).max()
                <= np.abs(ref[off] - exact[off]).max())


def test_tied_streamed_render_matches_jax_trace_path():
    """The terrain with an exact copy, in another colour, of every fifth
    triangle (above the table-resident size, ``check_scenes.
    tied_terrain_order``: each copy behind its original in one chunk, in
    another chunk of the same 32-triangle batch, in another super or in
    another segment): the port's fused plain version against JAX's
    brute-force wavefront (whose ties go to the lower scene id, the
    original's); every exact tie goes to the original (the lower row), so
    no bounce's winner is a copy, and ties do happen."""
    js, ts = _build(cs.fill_tied_terrain)
    _, plain_ts, o, d, _ = _streamed("terrain")
    ball, prob, stream = _stream()
    ref = np.asarray(jinteg.trace_path(
        js, jmake_rays(jnp.asarray(o), jnp.asarray(d)), jax.random.key(5),
        JConfig(width=16, height=32, samples=1, max_depth=DEPTH,
                quirks=JQuirks.fixed()),
        samples=jinteg.SampleStream(jnp.asarray(ball), jnp.asarray(prob))))
    tables = tmk.build_mega_tables(ts, cs.tied_terrain_order())
    assert tables.tri_seg.shape[0] == 7
    cfg = _cfg()
    rays = _trays(o, d)
    st = tmk.stream_tensor(stream, N_RAYS, DEPTH + 1)
    got, win = tmk.trace_path_mega_plain(tables, rays, cfg, st, None, True)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-4, rtol=1e-4)
    n_base = plain_ts.n_triangles
    tri = win - ts.n_spheres         # scene triangle ids, the sphere first
    assert not bool((tri >= n_base).any())
    assert int(((tri >= 0) & (tri % cs.TIE_EVERY == 0)).sum()) > 20


def _f64(x):
    """The scene (its dataclasses and named tuples) or a tensor with every
    float tensor in float64."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _f64(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_f64(v) for v in x))
    if torch.is_tensor(x) and x.is_floating_point():
        return x.double()
    return x


def test_streamed_winners_match_jax():
    """K7 on a streamed scene: the port's recorded winners on the terrain
    (plain version, Morton tables with the segment level) equal JAX's
    trace_path_mega(want_winners=True) in scene ids."""
    js, ts, o, d, (tri_o, sph_o) = _streamed("terrain")
    n = 128
    ball, prob = _stream_np(6, n, DEPTH)
    jcfg = JConfig(width=16, height=8, samples=1, max_depth=DEPTH,
                   quirks=JQuirks.fixed(), engine="mega")
    jt = jmk.build_mega_tables(js, tri_order=tri_o, sph_order=sph_o)
    jrad, jwin = jmk.trace_path_mega(
        js, jmake_rays(jnp.asarray(o[:n]), jnp.asarray(d[:n])),
        jax.random.key(0), jcfg, tables=jt,
        samples=jinteg.SampleStream(jnp.asarray(ball), jnp.asarray(prob)),
        want_winners=True)
    tables = tmk.build_mega_tables(ts, tri_o, sph_o)
    rad, win = tmk.trace_path_mega(
        ts, _trays(o[:n], d[:n]), _cfg(), tables=tables,
        samples=SampleStream(torch.from_numpy(ball), torch.from_numpy(prob)),
        want_winners=True)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad), atol=3e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_replay_follows_the_plain_path(profile):
    """The mega_diff replay on the plain version's recorded winners
    (three_spheres, glass and metal, 64x32x2, counter draws): no recorded
    winner fails its test on a replayed ray, and at the start of every
    bounce the replayed rays equal the plain version's (its window dump)
    bit for bit."""
    scene, cam = tpresets.three_spheres(aspect=2.0, device="cpu")
    o, d, t = _rays_np(cam, 11, 64, 32, 2)
    rays = Rays(*(torch.from_numpy(x) for x in (o, d, t)))
    cfg = RenderConfig(width=64, height=32, samples=2, max_depth=DEPTH,
                       quirks=getattr(Quirks, profile)(),
                       engine="mega_diff")
    tables = tmk.morton_tables(scene)
    _, win = tmk.trace_path_mega_plain(tables, rays, cfg, None, 41, True)
    assert (win[1] >= 0).any()
    wcfg = dataclasses.replace(cfg, engine="wavefront",
                               wavefront_tpu_prng=True)
    assert not tinteg.replay_misses(scene, rays, wcfg, win, seed=41).any()
    for step, ro, rd, _ in tinteg.replay_rays(scene, rays, wcfg, win,
                                              seed=41):
        if step == 0:
            continue
        ref = tmk.trace_path_mega_plain(
            tables, rays, cfg, None, 41, window=tmk.Window(
                0, step, torch.empty(tmk.N_PLANES, rays.origin.shape[0])))
        np.testing.assert_array_equal(ro.numpy(), ref[3:6].t().numpy())
        np.testing.assert_array_equal(rd.numpy(), ref[6:9].t().numpy())


def test_big_field_scenes_hold_bench_sizes():
    """The field stand-ins: 128,000 triangles (above AUTO_COMPACT_TRIS:
    the phased octant route) and 1,044,480 (under MAX_STREAM_PRIMS)."""
    scene, cam = cs.big_field_scene(16 / 9, device="cpu")
    assert scene.n_triangles == 128000 >= tmk.AUTO_COMPACT_TRIS
    tables = tmk.morton_tables(scene)
    assert tables.tri_seg.shape == (63, 8) and tables.tri.shape[0] == 129024
    assert cs.big1m_scene(16 / 9, device="cpu")[0].n_triangles == 1044480 <= \
        tmk.MAX_STREAM_PRIMS
