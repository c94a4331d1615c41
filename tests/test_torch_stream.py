"""Scenes above the table-resident size and the compaction drivers on the
CPU: the segment level (kernel mode K6), the bounce windows (K10) and the
front-to-back shells (K11) of the port's fused engine against the JAX
package, and the mega_diff replay's discrete decisions.

The streamed scenes are tests/test_megakernel.py's: a 10,368-triangle
terrain (:202-230) and a 96 x 96 sphere field (:790-806), built by the same
fill functions in both packages, with 512 rays cast from above and an
injected scatter stream made with numpy.  Their renders are held against
the JAX package's brute-force ``integ.trace_path`` (its interpret-mode
fused drivers are too slow at this size); the JAX fused drivers run on a
small resident scene.

Tolerances:
  * tables: equal to the JAX tables' boxes, rows and maps, exactly;
  * streamed renders against JAX ``trace_path``: atol 3e-4, rtol 1e-4, as
    tests/test_megakernel.py holds JAX's own engines;
  * the drivers (phased, compact, routed) against the port's monolithic
    render: bit for bit (assert_array_equal), under injected and counter
    draws alike, since the draws are keyed by ray id;
  * the phased driver against JAX's on the mixed scene: atol 2e-4, rtol
    1e-4, as tests/test_torch_megakernel.py holds the fused engines;
  * winners against JAX's: equal on every ray and bounce;
  * the mega_diff replay against the plain version: rays bit for bit and
    no recorded winner missed;
  * the plain window over the planes (K10) under any order of the rays,
    and its regrouping keys against the drivers' former Morton and octant
    sorts: exactly; the model of the cooperative shell walk (K11): each
    ray's visit sequence equal to the per-thread one's.
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
from test_torch_megakernel import _np_tree, _rays_np, _stream_np
from test_megakernel import _mixed_scene

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


@pytest.mark.parametrize("draws", ["injected", "counter"])
def test_windowed_plain_dump_resumes_exactly(draws):
    """The plain version's window over the planes: [0, 2) writes the 13
    planes [rad | o | d | thr | alive] of every ray in its column; resuming
    [2, D + 1) in place, the rays served in reverse order, adds up to the
    unbroken render bit for bit, and leaves the dead rays' columns as they
    were."""
    _, ts, o, d, orders = _streamed("sphere_field")
    tables = tmk.build_mega_tables(ts, *orders)
    rays = _trays(o, d)
    stream = tmk.stream_tensor(_stream()[2], N_RAYS, DEPTH + 1) \
        if draws == "injected" else None
    cfg = _cfg("reference")
    want = tmk.trace_path_mega_plain(tables, rays, cfg, stream, 5)
    planes = torch.full((tmk.N_PLANES, N_RAYS), float("nan"))
    a = tmk.trace_path_mega_plain(tables, rays, cfg, stream, 5,
                                  window=tmk.Window(0, 2, planes))
    assert a is planes and not planes.isnan().any()
    assert set(a[12].tolist()) <= {0.0, 1.0} and a[12].any()
    was_dead = a[12] == 0.0
    dead = a[:, was_dead].clone()
    assert dead.shape[1] > 0
    rev = torch.arange(N_RAYS - 1, -1, -1, dtype=torch.int32)
    tmk.trace_path_mega_plain(tables, rays, cfg, stream, 5,
                              window=tmk.Window(2, None, planes, rev))
    np.testing.assert_array_equal(planes[:3].t().numpy(), want.numpy())
    np.testing.assert_array_equal(planes[:, was_dead].numpy(), dead.numpy())


def _box_dist2(seg: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The kernel's box_dist2 of origins float32[R, 3] to boxes float32[S,
    8] -> float32[R, S]."""
    q = torch.minimum(torch.maximum(o[:, None], seg[None, :, 0:3]),
                      seg[None, :, 3:6]) - o[:, None]
    return q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] + q[..., 2] * q[..., 2]


def _shells(seg: torch.Tensor, o: torch.Tensor, b: int) -> np.ndarray:
    """Each ray's shell of each box, as tri_shells ranks them ->
    int[R, S]."""
    d2 = _box_dist2(seg, o)
    dmin, dmax = d2.amin(1, keepdim=True), d2.amax(1, keepdim=True)
    scale = b / torch.clamp(dmax - dmin, min=1e-30)
    q = torch.floor((d2 - dmin) * scale)
    return torch.where(q >= 0, torch.clamp(q, max=b - 1), 0).long().numpy()


def _warp_walk(shells: np.ndarray, alive: np.ndarray, b: int) -> list:
    """A model of tri_shells_coop for one warp of 32 rays: per group of 32
    shells the union of the lanes' one-hot shell bits per box (lane t keeps
    box 32 w + t's), one ballot per shell into bits[s][w], then the walk of
    the set bits in (shell, table) order with __ffs, each lane entering box
    j in its own shell's pass -> each lane's visit sequence.  Asserts that
    every pair walked has a lane that enters it."""
    n_top = shells.shape[1]
    nw = -(-n_top // 32)
    visits = [[] for _ in range(32)]
    for g in range(0, b, 32):
        gb = min(b - g, 32)
        bits = np.zeros((gb, nw), np.int64)
        for w in range(nw):
            mine = np.zeros(32, np.int64)
            for t in range(min(n_top - 32 * w, 32)):
                s = np.where(alive, shells[:, 32 * w + t] - g, -1)
                onehot = np.where((s >= 0) & (s < 32), 1 << np.clip(s, 0, 31),
                                  0)
                mine[t] = np.bitwise_or.reduce(onehot)
            for sh in range(gb):
                bits[sh, w] = int(((mine >> sh) & 1) @ (1 << np.arange(32)))
        for sh in range(gb):
            for w in range(nw):
                m = int(bits[sh, w])
                while m:
                    j = 32 * w + (m & -m).bit_length() - 1
                    m &= m - 1
                    enter = alive & (shells[:, j] == g + sh)
                    assert enter.any(), "a vote on a pair no lane holds"
                    for lane in np.nonzero(enter)[0]:
                        visits[lane].append(j)
    return visits


def _walk_cases():
    """(top-level boxes, origins, alive) of the terrain's and a 20,480-
    triangle field's rays after one bounce (the plain version's window
    [0, 1)), and of 70 random boxes (three words of segments) seen from 512
    random origins."""
    _, ts, o, d, orders = _streamed("terrain")
    sf, cam = cs.field_scene(2, 2, 2.0, device="cpu")
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    fr = generate_pixel_rays(cam, 32, 16, 1, torch.arange(512),
                             generator=torch.Generator().manual_seed(2))
    out = []
    for tables, rays in ((tmk.build_mega_tables(ts, *orders), _trays(o, d)),
                         (tmk.morton_tables(sf), fr)):
        planes = torch.empty(tmk.N_PLANES, rays.origin.shape[0])
        tmk.trace_path_mega_plain(tables, rays, _cfg(), None, 3,
                                  window=tmk.Window(0, 1, planes))
        out.append((tables.tri_seg, planes[3:6].t(), planes[12] > 0))
    rng = np.random.default_rng(4)
    lo = rng.uniform(-10, 10, (70, 3)).astype(np.float32)
    seg = torch.from_numpy(np.concatenate(
        [lo, lo + rng.uniform(0.1, 3, (70, 3)).astype(np.float32),
         np.zeros((70, 2), np.float32)], 1))
    org = torch.from_numpy(rng.uniform(-12, 12, (512, 3)).astype(np.float32))
    out.append((seg, org, torch.from_numpy(rng.uniform(size=512) < 0.8)))
    return out


@pytest.mark.parametrize("shells", [1, 3, 8, 40])
def test_cooperative_shell_walk_keeps_each_rays_order(shells):
    """K11 under COOP, modelled warp by warp (32 rays, the union masks, the
    groups of 32 shells, dead lanes): every ray visits exactly the boxes of
    the per-thread tri_shells, in its order, and every (shell, box) pair
    the warp walks has a ray that enters it.  On the terrain's 6 segments,
    the field's 10 and 70 random boxes."""
    for seg, o, alive in _walk_cases():
        sh = _shells(seg, o, shells)
        assert len(np.unique(sh)) > min(shells, 2) - 1
        alive = alive.numpy()
        for w0 in range(0, o.shape[0], 32):
            lanes = slice(w0, w0 + 32)
            got = _warp_walk(sh[lanes], alive[lanes], shells)
            for lane, seq in enumerate(got):
                want = (sorted(range(seg.shape[0]),
                               key=lambda j: (sh[w0 + lane, j], j))
                        if alive[w0 + lane] else [])
                assert seq == want


def _morton_order_before(o, d, alive, octants):
    """The drivers' regrouping before the keys moved into the kernel: the
    30-bit Morton code of origins quantized over their own range, in int64
    (the octant key or the code), dead rays last, a stable argsort."""
    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    def q(a):
        lo = a.min()
        span = torch.clamp(a.max() - lo, min=1e-20)
        return torch.clamp((a - lo) / span * 1023.0, 0.0, 1023.0).to(
            torch.int64)

    code = (spread(q(o[:, 0])) << 2) | (spread(q(o[:, 1])) << 1) | spread(
        q(o[:, 2]))
    if octants:
        oct_ = (((d[:, 0] < 0).to(torch.int64) << 2)
                | ((d[:, 1] < 0).to(torch.int64) << 1)
                | (d[:, 2] < 0).to(torch.int64))
        code = (((code >> 18) << 18) | (oct_ << 15)
                | ((code >> 3) & ((1 << 15) - 1)))
    return torch.argsort(torch.where(alive, code, tmk.DEAD_KEY), stable=True)


def test_regroup_keys():
    """The plain key function (K10), on the sphere field's rays after two
    bounces: the octant bits are the direction's signs, dead rays take
    DEAD_KEY and sort last, alive-first keeps the ray order within each
    group, and over the origins' own range the Morton and octant keys sort
    as the drivers sorted before (today's Morton order)."""
    _, ts, o, d, orders = _streamed("sphere_field")
    tables = tmk.build_mega_tables(ts, *orders)
    planes = torch.empty(tmk.N_PLANES, N_RAYS)
    tmk.trace_path_mega_plain(tables, _trays(o, d), _cfg(), None, 6,
                              window=tmk.Window(0, 2, planes))
    o2, d2, alive = planes[3:6].t(), planes[6:9].t(), planes[12] > 0
    assert 0 < int(alive.sum()) < N_RAYS
    bounds = tables.key_bounds
    assert bounds.shape == (2, 3) and bool((bounds[1] > 0).all())
    for mode in (tmk.KEY_ALIVE, tmk.KEY_OCTANT, tmk.KEY_MORTON):
        key = tmk.regroup_keys(o2, d2, alive, mode, bounds)
        assert key.dtype == torch.int32
        assert bool((key[~alive] == tmk.DEAD_KEY).all())
        assert bool((key[alive] < tmk.DEAD_KEY).all())
        order = tmk._next_order(key)
        assert order.dtype == torch.int32
        assert bool(alive[order.long()][:int(alive.sum())].all())
    key = tmk.regroup_keys(o2, d2, alive, tmk.KEY_OCTANT, bounds)
    neg = (d2 < 0).to(torch.int32)
    assert torch.equal(((key >> 15) & 7)[alive],
                       ((neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2])[alive])
    key = tmk.regroup_keys(o2, d2, alive, tmk.KEY_ALIVE, bounds)
    assert torch.equal(tmk._next_order(key).long(), torch.cat(
        [torch.nonzero(alive)[:, 0], torch.nonzero(~alive)[:, 0]]))
    lo = o2.amin(0)
    own = torch.stack([lo, torch.clamp(o2.amax(0) - lo, min=1e-20)])
    for mode, octants in ((tmk.KEY_MORTON, False), (tmk.KEY_OCTANT, True)):
        key = tmk.regroup_keys(o2, d2, alive, mode, own)
        assert torch.equal(tmk._next_order(key).long(),
                           _morton_order_before(o2, d2, alive, octants))


def test_plain_window_is_independent_of_the_order():
    """The plain window over the planes under a shuffled order gives the
    planes and keys of the identity order, at step 0 and resumed (the
    draws and the injected stream's row follow the ray id)."""
    _, ts, o, d, orders = _streamed("terrain")
    tables = tmk.build_mega_tables(ts, *orders)
    rays = _trays(o, d)
    stream = tmk.stream_tensor(_stream()[2], N_RAYS, DEPTH + 1)
    shuffled = torch.randperm(
        N_RAYS, generator=torch.Generator().manual_seed(9)).to(torch.int32)
    got = []
    for order in (None, shuffled):
        planes = torch.empty(tmk.N_PLANES, N_RAYS)
        key = torch.empty(N_RAYS, dtype=torch.int32)
        tmk.trace_path_mega_plain(tables, rays, _cfg(), stream, 0,
                                  window=tmk.Window(0, 2, planes, order, key,
                                                    tmk.KEY_OCTANT))
        first = planes.clone(), key.clone()
        tmk.trace_path_mega_plain(tables, rays, _cfg(), stream, 0,
                                  window=tmk.Window(2, 2, planes, order, key,
                                                    tmk.KEY_OCTANT))
        got.append((first, (planes, key)))
    for (a, ka), (b, kb) in zip(*got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert torch.equal(ka, kb)


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


def test_fused_drivers_reject_other_integrators():
    scene, _ = tpresets.three_spheres(device="cpu")
    rays = _trays(*cs.terrain_rays(4))
    with pytest.raises(ValueError, match="path integrator"):
        tmk.trace_path_mega_phased(scene, rays, _cfg(integrator="lambert"))
    with pytest.raises(ValueError, match="bounce window"):
        tmk.trace_path_mega(scene, rays, _cfg(integrator="normal"),
                            window=tmk.Window(0, 2, torch.empty(13, 4)))


def test_big_field_scenes_hold_bench_sizes():
    """The field stand-ins: 128,000 triangles (above AUTO_COMPACT_TRIS:
    the phased octant route) and 1,044,480 (under MAX_STREAM_PRIMS)."""
    scene, cam = cs.big_field_scene(16 / 9, device="cpu")
    assert scene.n_triangles == 128000 >= tmk.AUTO_COMPACT_TRIS
    tables = tmk.morton_tables(scene)
    assert tables.tri_seg.shape == (63, 8) and tables.tri.shape[0] == 129024
    assert cs.big1m_scene(16 / 9, device="cpu")[0].n_triangles == 1044480 <= \
        tmk.MAX_STREAM_PRIMS
