"""K8's culled walk over the rect / TRS rows on the CPU: the chunk tables
that ``build_mega_tables`` gives the kernel (``_xform_chunks``), the plain
version of the walk (``megakernel.xform_walk_plain``: the chunk test and
the (t, class, row) rule) against the brute force (``_sweep_plain``), and
the fused engine on a TRS field whose rows each have an exact copy against
the JAX package.

Scenes come from ``check_scenes.fill_trs_field`` (the generator of
tests/test_transform_prims.py:168-207), rays from the port's camera and
``check_scenes.xform_edge_rays`` (rect edges, TRS sphere tangents, TRS
triangle vertices, axis-parallel rays).

Tolerances: the walk's (t, class, row) equal the brute force's bit for bit
(the same formulas on the same rows; the cull only skips rows that cannot
win); the chunk boxes hold their rows' world objects with at least 0.99 of
the margin to spare (the objects in float64 against boxes computed in
float32); radiance against JAX as tests/test_torch_xform.py holds it (atol
3e-4, at most 0.5% of rays above it).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import Quirks as JQuirks
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core import camera as jcam
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
from cudaraytracer_tpu_torch.core import camera as tcam
from cudaraytracer_tpu_torch.core import vec as tv3
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.utils.convert import scene_from_numpy
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_torch_xform import (_assert_radiance, _both, _inputs, _np_tree,
                              _tcfg)

FIELD = 200          # rows a class: above XFORM_CULL_MIN, in 25 chunks
N_EDGE = 512         # rays of each xform_edge_rays set
CFG = RenderConfig(width=32, height=16, samples=1, max_depth=3,
                   quirks=Quirks.fixed(), engine="mega")


@functools.lru_cache(maxsize=None)
def _field(k=FIELD, copies=1):
    scene, cam = (cs.trs_field_scene(k, 2.0, device="cpu") if copies == 1
                  else cs.trs_duplicates_scene(k, 2.0, device="cpu"))
    return scene, cam


@functools.lru_cache(maxsize=None)
def _tables(k=FIELD):
    return tmk.morton_tables(_field(k)[0])


def _camera_rays(cam, seed=1):
    return tcam.generate_pixel_rays(
        cam, CFG.width, CFG.height, 1,
        generator=torch.Generator().manual_seed(seed))


def _world_objects(scene, name):
    """float64[K, P, 3] world points of each row's object (rect corners,
    TRS triangle vertices, TRS sphere centres) and float64[K] radii (0 but
    for spheres), computed here: M^T (q + p)."""
    trs, radius = {"rect": (scene.rects.trs, None),
                   "tsph": (scene.t_spheres.trs, scene.t_spheres.radius),
                   "ttri": (scene.t_triangles.trs, None)}[name]
    R = tv3.rotation_matrix_euler_deg(trs.rotation).double().numpy()
    p = trs.position.double().numpy()
    k = len(p)
    if name == "rect":
        q = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [-0.5, 0.5, 0],
                      [0.5, 0.5, 0]], np.float64)[None].repeat(k, 0)
    elif name == "tsph":
        q = np.zeros((k, 1, 3))
    else:
        tt = scene.t_triangles
        q = np.stack([x.double().numpy() for x in (tt.v0, tt.v1, tt.v2)], 1)
    w = np.einsum("kij,kpi->kpj", R, q + p[:, None, :])
    r = (np.abs(radius.double().numpy()) if radius is not None
         else np.zeros(k))
    return w, r


@pytest.mark.parametrize("name", tmk.XFORM_CLASSES)
def test_chunk_boxes_hold_their_rows(name):
    """Each chunk's box holds its rows' world objects (corners, vertices,
    centre +- r) widened by XFORM_MARGIN x their box's largest
    |coordinate|, its scale range holds its rows' scales, max b is the
    largest b; the order is a permutation of the rows."""
    scene, _ = _field()
    tables = _tables()
    box = getattr(tables, name + "_box").double().numpy()
    order = getattr(tables, name + "_ord").long().numpy()
    k = getattr(tables, name).shape[0]
    assert box.shape == (-(-k // tmk.XFORM_CHUNK), tmk.XBOX_COLS)
    assert sorted(order.tolist()) == list(range(k))
    w, r = _world_objects(scene, name)
    scale = getattr(scene, {"rect": "rects", "tsph": "t_spheres",
                            "ttri": "t_triangles"}[name]).trs.scale
    scale = scale.double().numpy()
    for j in range(box.shape[0]):
        rows = order[j * tmk.XFORM_CHUNK:(j + 1) * tmk.XFORM_CHUNK]
        lo = (w[rows].min(1) - r[rows, None]).min(0)
        hi = (w[rows].max(1) + r[rows, None]).max(0)
        m = tmk.XFORM_MARGIN * max(np.abs(lo).max(), np.abs(hi).max())
        assert (box[j, 0:3] <= lo - 0.99 * m).all()
        assert (box[j, 3:6] >= hi + 0.99 * m).all()
        a, b = box[j, 6:9], box[j, 9:12]
        assert (a <= scale[rows].min(0)).all() and (a > 0).all()
        assert (b >= scale[rows].max(0)).all()
        assert box[j, tmk.XB_BMAX] == b.max()


def test_few_rows_take_the_flat_walk():
    """Below XFORM_CULL_MIN rows a class has no chunks (the showcase's four
    rows, light_box's one rect); at it, ceil(rows / 16)."""
    scene, _ = _field(tmk.XFORM_CULL_MIN - 1)
    tables = tmk.morton_tables(scene)
    for name in tmk.XFORM_CLASSES:
        assert getattr(tables, name + "_box").shape == (0, tmk.XBOX_COLS)
        assert getattr(tables, name + "_ord").shape == (0,)
    scene, _ = _field(tmk.XFORM_CULL_MIN)
    tables = tmk.morton_tables(scene)
    n_chunks = -(-tmk.XFORM_CULL_MIN // tmk.XFORM_CHUNK)
    assert tables.rect_box.shape == (n_chunks, tmk.XBOX_COLS)


def _rays_of(scene, cam, which):
    """Camera rays, or one ``xform_edge_rays`` set."""
    if which == "camera":
        r = _camera_rays(cam)
        return r.origin, r.direction
    o, d = cs.xform_edge_rays(scene, N_EDGE, 7)[which]
    return torch.from_numpy(o), torch.from_numpy(d)


def _assert_walk_matches(tables, o, d, cfg):
    ref = tmk._sweep_plain(tables, o, d, tmk._inv_len(d), cfg)
    t, cls, idx, counts = tmk.xform_walk_plain(tables, o, d, cfg)
    hit = ref.t < tmk.BIG_CUT
    assert torch.equal(t, ref.t)
    assert torch.equal(cls[hit], ref.cls[hit])
    assert torch.equal(idx[hit], ref.idx[hit])
    return counts, ref


RAY_SETS = ["camera", "rect_edges", "tsph_tangent", "ttri_vertices",
            "axis_parallel"]


@pytest.mark.parametrize("which", RAY_SETS)
@pytest.mark.parametrize("profile", ["reference", "fixed"])
def test_culled_walk_matches_the_brute_force(which, profile):
    """The chunk test and the (t, class, row) rule give the brute force's
    winner on every ray of 200 rows a class, and the cull skips rows."""
    scene, cam = _field()
    tables = _tables()
    cfg = dataclasses.replace(CFG, quirks=getattr(Quirks, profile)())
    o, d = _rays_of(scene, cam, which)
    counts, ref = _assert_walk_matches(tables, o, d, cfg)
    n = o.shape[0]
    assert bool((ref.cls >= tmk.C_RECT).any())
    brute = n * 3 * FIELD
    assert counts["rect"] + counts["tsph"] + counts["ttri"] < 0.75 * brute


@pytest.mark.parametrize("which", ["camera", "rect_edges", "axis_parallel"])
def test_ties_across_chunks_go_to_the_lowest_row(which):
    """Every row copied once, the copies walked first (earlier chunks,
    higher rows): each exact tie is won by the lowest row, as the brute
    force's first-row rule gives it, under the copies-first order and the
    Morton order alike."""
    k = 40
    scene, cam = _field(k, copies=2)
    o, d = _rays_of(scene, cam, which)
    first = tmk.build_mega_tables(scene,
                                  xform_orders=cs.duplicate_orders(k))
    assert first.rect_ord[0] == k
    _, ref = _assert_walk_matches(first, o, d, CFG)
    x = ref.cls >= tmk.C_RECT
    assert bool(x.any()) and bool((ref.idx[x] < k).all())
    _assert_walk_matches(tmk.morton_tables(scene), o, d, CFG)


def test_hits_lie_in_their_chunks_boxes():
    """A row's accepted hit at native t is the world point o + t
    normalize(d / s) inside its chunk's box: the geometry the chunk test
    rests on (the world object M^T (S + p), the ray bent by the scale)."""
    scene, cam = _field()
    tables = _tables()
    o, d = _rays_of(scene, cam, "camera")
    oc = [o[:, k:k + 1] for k in range(3)]
    dc = [d[:, k:k + 1] for k in range(3)]
    t_min, t_max = float(np.float32(CFG.t_min)), float(np.float32(CFG.t_max))
    n_hits = 0
    for _, name, test in tmk._XFORM:
        rows = getattr(tables, name)
        box = getattr(tables, name + "_box").double()
        chunk = torch.empty(rows.shape[0], dtype=torch.long)
        chunk[getattr(tables, name + "_ord").long()] = torch.arange(
            rows.shape[0]) // tmk.XFORM_CHUNK
        valid, tn = test(rows, *tmk._xray(rows, oc, dc), t_min, t_max,
                         CFG.quirks)
        ray, row = torch.nonzero(valid, as_tuple=True)
        s = rows[row, tmk.X_SCL:tmk.X_SCL + 3].double()
        dn = d[ray].double() / s
        dn = dn / dn.norm(dim=1, keepdim=True)
        w = o[ray].double() + tn[ray, row].double()[:, None] * dn
        b = box[chunk[row]]
        assert bool(((w >= b[:, 0:3]) & (w <= b[:, 3:6])).all())
        n_hits += len(row)
    assert n_hits > 300


def test_fused_copied_field_matches_jax():
    """A TRS field of 8 rows a class, each copied once (16 a class, the
    fused JAX engine's scene): the port's fused plain version on tables
    whose K8 order walks the copies first against the JAX wavefront and the
    JAX fused engine, 32x16x1, depth 3, one injected stream."""
    k = 8
    cam = jcam.make_camera((0, 0.3, 1), (0, 0.3, -3), vfov=60, aspect=2.0,
                           focus_dist=4.0)
    js = cs.fill_trs_field(JSceneBuilder(), k, copies=2).build()
    ts = scene_from_numpy(_np_tree(js), "cpu")
    assert ts.n_rects == ts.n_t_spheres == ts.n_t_triangles == 2 * k
    jcfg = JConfig(width=32, height=16, samples=1, max_depth=3,
                   quirks=JQuirks.fixed())
    (jr, jst), (tr, tst) = _both(*_inputs(cam, 3, 32, 16, 1, 3))
    ref = np.asarray(jinteg.trace_path(js, jr, jax.random.key(0), jcfg,
                                       samples=jst))
    tcfg = dataclasses.replace(_tcfg(jcfg), engine="mega")
    orders = cs.duplicate_orders(k)
    saved = tmk.XFORM_CULL_MIN
    tmk.XFORM_CULL_MIN = 1                  # chunks at 16 rows a class
    try:
        tables = tmk.build_mega_tables(ts, xform_orders=orders)
    finally:
        tmk.XFORM_CULL_MIN = saved
    assert tables.rect_box.shape[0] == -(-2 * k // tmk.XFORM_CHUNK)
    assert int(tables.rect_ord[0]) == k
    got = tmk.trace_path_mega(ts, tr, tcfg, tables=tables, samples=tst)
    assert ref.std() > 0.03
    _assert_radiance(got.numpy(), ref)
    o, d = tr.origin, tr.direction
    _assert_walk_matches(tables, o, d, tcfg)
