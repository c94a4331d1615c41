"""The big field's cell: its frozen layout against the program's field, the
fixed-quirk mesh reference on hand cases and against the program's plain
kernel, the cell at a small size on the CPU (correct, repeating for a
seed, its control and a planted fault rejected), the readers of the
streamed route's spans, and on the card the route a full-size frame
takes.  The small sizes are this file's own (a 2 x 2 field of 320-triangle
icospheres, 32 x 18 pixels)."""

import copy

import numpy as np
import pytest
import torch

from rtbench import faults, harness, tracing
from rtbench.drivers import mesh_render
from rtbench.inputs import big_field
from rtbench.reference import mesh, tracer

CELL = "big_field.path8"
SEED = 2 ** 35 + 11
FIXED = {"t_min": 1e-3, "t_max": 3.4028235e38, "max_depth": 8,
         "integrator": "path"}


def small_cell(bench, **render) -> harness.Cell:
    """The cell on a 2 x 2 field of subdivision-2 icospheres (1,280
    triangles) at 32 x 18 x 2, 256-ray chunks, 64 picks."""
    cell = harness.Cell(CELL, bench)
    cell.spec = {**copy.deepcopy(cell.spec), "picks": 64}
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(copies=[2, 2], subdivisions=2)
    cell.config["render"].update({"width": 32, "height": 18, "samples": 2,
                                  "ray_chunk": 256, **render})
    return cell


def _driver(cell, seed=SEED):
    drv = harness.driver_of(cell).Driver(cell, seed, torch.device("cpu"),
                                         tracing.Spans())
    drv.setup()
    return drv


def failing(cell, items) -> bool:
    lim = cell.spec["limits"]
    return any(not (item[k] <= lim[k]) for item in items for k in lim)


def test_the_frozen_layout_is_the_programs_field(bench):
    from cudaraytracer_tpu_torch.models import check_scenes
    points, faces, normals, ext = big_field.field_mesh(5, 5)
    want = check_scenes.icosphere_field_mesh(5, 5)
    for got, exp in zip((points, faces, normals, ext), want):
        assert got.dtype == exp.dtype and np.array_equal(got, exp)
    cfg = harness.Cell(CELL, bench).config
    assert faces.shape[0] == cfg["triangles"] == 128000
    a = big_field.scene_arrays(SEED)
    scene = mesh_render.program_scene(a, "cpu")
    ref, cam = check_scenes.big_field_scene(16 / 9, device="cpu")
    for k in ("v0", "v1", "v2", "normal"):
        assert torch.equal(getattr(scene.triangles, k),
                           getattr(ref.triangles, k)), k
    tri = torch.as_tensor(big_field.triangles(a))
    assert torch.equal(tri[:, 0], scene.triangles.v0)
    assert torch.equal(tri[:, 2], scene.triangles.v2)
    from rtbench.drivers import _common
    got = _common.program_camera(big_field.camera_params(16 / 9), "cpu")
    for x, y in zip(got, cam):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_the_albedos_follow_the_seed_and_the_layout_does_not():
    a, b, c = (big_field.scene_arrays(s, (2, 2), 1) for s in
               (5, 5, 2 ** 62 + 1))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    for k in ("points", "faces", "normals", "copy"):
        assert np.array_equal(a[k], c[k])
    assert not np.array_equal(a["albedo"], c["albedo"])
    assert a["albedo"].shape == (4, 3) and a["copy"].tolist() == (
        [0] * 80 + [1] * 80 + [2] * 80 + [3] * 80)


def _one_triangle(z=-2.0, nz=1.0):
    v = torch.tensor([[[-1.0, -1.0, z], [1.0, -1.0, z], [0.0, 1.0, z]]])
    return v, torch.tensor([[0.0, 0.0, nz]])


@pytest.mark.parametrize("nz", [1.0, -1.0])
def test_either_face_is_hit(nz):
    """Two-sided: a ray meets the face whether its normal faces the ray or
    not, and the hit keeps the stored normal."""
    v, n = _one_triangle(nz=nz)
    pr = mesh.mesh_prims(v, n, torch.tensor([[0.5, 0.5, 0.5]]))
    h = mesh.closest_hit(pr, torch.zeros(1, 3),
                         torch.tensor([[0.0, 0.0, -1.0]]), FIXED)
    assert bool(h.hit[0]) and h.t[0].item() == pytest.approx(2.0)
    assert h.n[0].tolist() == [0.0, 0.0, nz]


def test_a_hit_at_or_below_t_min_does_not_count():
    """t is clipped to (t_min, t_max): behind the origin, at the origin and
    within t_min of it is a miss; the reference's quirk would hit behind
    the origin."""
    pr = mesh.mesh_prims(*_one_triangle(), torch.tensor([[0.5, 0.5, 0.5]]))
    d = torch.tensor([[0.0, 0.0, -1.0]])
    for oz in (-3.0, -2.0, -2.0 + 5e-4):      # t = -1, 0, 5e-4
        h = mesh.closest_hit(pr, torch.tensor([[0.0, 0.0, oz]]), d, FIXED)
        assert not bool(h.hit[0]), oz
    h = mesh.closest_hit(pr, torch.tensor([[0.0, 0.0, -1.99]]), d, FIXED)
    assert bool(h.hit[0]) and h.t[0].item() == pytest.approx(0.01)


def test_a_tie_goes_to_the_first_triangle():
    """Two triangles at the same depth: the first in the table wins, in one
    block and across blocks."""
    v, n = _one_triangle()
    for copies in (2, 5000):                  # 5,000 spans blocks
        pr = mesh.mesh_prims(v.expand(copies, 3, 3), n.expand(copies, 3),
                             torch.rand(copies, 3))
        t, i = tracer._closest(lambda lo, hi: mesh.triangle_t(
            torch.zeros(4096, 3), torch.tensor([[0.0, 0.0, -1.0]]).expand(
                4096, 3), pr.v0[lo:hi], pr.e1[lo:hi], pr.e2[lo:hi], 1e-3,
            3.4e38), copies, torch.zeros(4096, 3))
        assert (i == 0).all() and torch.allclose(t, torch.full_like(t, 2.0))
        h = mesh.closest_hit(pr, torch.zeros(1, 3),
                             torch.tensor([[0.0, 0.0, -1.0]]), FIXED)
        assert torch.equal(h.m[0], pr.t_mat[0])


def test_an_absorbed_path_adds_nothing():
    """A hit that may not scatter (depth 0) returns 0, not the reference's
    0.1 of ambient."""
    pr = mesh.mesh_prims(*_one_triangle(), torch.tensor([[0.5, 0.5, 0.5]]))
    out = mesh.path_radiance(pr, torch.zeros(2, 3),
                             torch.tensor([[0.0, 0.0, -1.0],
                                           [0.0, 1.0, 0.0]]),
                             torch.zeros(2, dtype=torch.int64),
                             torch.arange(2), dict(FIXED, max_depth=0))
    assert out[0].tolist() == [0.0, 0.0, 0.0]
    assert out[1].tolist() == pytest.approx([0.5, 0.7, 1.0])   # the sky


def test_the_reference_matches_the_programs_plain_kernel():
    """On a small field, from the field's camera, the reference and the
    program's plain fused kernel under the fixed quirks agree bit for
    bit."""
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    a = big_field.scene_arrays(9, (3, 2), 2)
    scene = mesh_render.program_scene(a, "cpu")
    g = torch.Generator().manual_seed(0)
    o = torch.tensor([0.0, 2.2, 3.2]).expand(512, 3).contiguous()
    d = (torch.rand(512, 3, generator=g) - 0.5) * torch.tensor(
        [1.6, 0.8, 0.4]) + torch.tensor([0.0, -0.4, -1.0])
    cfg = mesh_render.render_config({
        **FIXED, "width": 1, "height": 1, "samples": 1, "gamma": True,
        "clip": True, "ray_chunk": 512, "engine": "mega", "quirks": "fixed"})
    want = mk.trace_path_mega_plain(mk.morton_tables(scene),
                                    Rays(o, d, o.new_zeros(0)), cfg,
                                    seed=77)
    pr = mesh.mesh_prims(torch.as_tensor(big_field.triangles(a)),
                         torch.as_tensor(a["normals"]),
                         torch.as_tensor(a["albedo"][a["copy"]]))
    got = mesh.path_radiance(pr, o, d, torch.full((512,), 77),
                             torch.arange(512), FIXED)
    assert (got > 0).any() and (got != got[:1]).any()
    assert torch.equal(got, want)


def test_the_small_cell_is_correct_and_repeats_for_a_seed(bench):
    kept = []
    for _ in range(2):
        drv = _driver(small_cell(bench))
        drv.unit()
        kept.append(drv.kept[0])
    assert np.array_equal(kept[0], kept[1])
    line = harness.run_cell(small_cell(bench), SEED, 1e-3, False, "cpu")
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["metrics"]) == {"frame_s", "setup_s"}


def test_the_control_and_a_brighter_frame_fail_the_limits(bench):
    cell = small_cell(bench)
    drv = _driver(cell)
    drv.unit()
    assert not failing(cell, drv.check(torch.float32))
    assert failing(cell, drv.control(torch.bfloat16))
    with faults.FAULTS["pixel_step"]():
        line = harness.run_cell(cell, SEED, 1e-3, False, "cpu")
    assert line["correct"] is False and line["failed"] >= 1


def test_the_cell_refuses_other_quirks_and_tables(bench):
    with pytest.raises(ValueError, match="fixed quirks"):
        _driver(small_cell(bench, quirks="reference"))
    with pytest.raises(ValueError, match="Morton"):
        _driver(small_cell(bench, tables="scene"))


def test_a_traced_small_run_reads_the_route(bench):
    """The small field is resident and monolithic: one window a chunk and
    no regroup, so the regroup reads 0.0; no CUDA events on the CPU, so
    the window's device ms reads nothing."""
    line = harness.run_cell(small_cell(bench), 7, 1e-3, True, "cpu")
    assert line["correct"]
    assert line["metrics"]["stream.regroup_device_ms"]["value"] == 0.0
    assert "stream.window_device_ms" not in line["metrics"]


class Ctx:
    def __init__(self, host, items=2):
        hosts = [tracing.Op(n, "user_annotation", s, e) for n, s, e in host]
        self.trace = tracing.DeviceTrace([], hosts, (0.0, 1000.0), items)
        self.spans, self.data = tracing.Spans(), None


def _reader(bench, name):
    return harness.reader_of(harness.Cell(CELL, bench), name).read


def test_the_route_readers_on_made_up_spans(bench, monkeypatch):
    from cudaraytracer_tpu_torch.utils import profiling
    recs = [("mega.window", 9.0), ("mega.window", 3.0),
            ("mega.regroup", 0.5), ("mega.window", 2.0),
            ("mega.regroup", 0.25)]
    monkeypatch.setattr(profiling, "records", lambda: [
        {"name": n, "device_ms": ms} for n, ms in recs])
    window = _reader(bench, "stream.window_device_ms")
    regroup = _reader(bench, "stream.regroup_device_ms")
    # the trace holds the newest two windows and both regroups, 2 frames
    ctx = Ctx([("mega.window", 0, 1), ("mega.window", 2, 3),
               ("mega.regroup", 4, 5), ("mega.regroup", 6, 7)])
    assert window(ctx) == pytest.approx(2.5)
    assert regroup(ctx) == pytest.approx(0.375)
    # a monolithic route: windows, no regroup
    assert regroup(Ctx([("mega.window", 0, 1)])) == 0.0
    # a program without the spans (the parent commit): neither
    assert window(Ctx([("frame", 0, 9)])) is None
    assert regroup(Ctx([("frame", 0, 9)])) is None
    recs[-1] = ("mega.regroup", None)          # an event not reached
    assert regroup(ctx) is None


@pytest.mark.gpu
def test_a_full_frame_takes_the_phased_route(cuda, bench):
    """A full-size frame of the cell on the card: 29 chunks of 5 windows,
    each streamed (K6) with 8 shells (K11), and 4 sorts a chunk, counted
    by the launch counters and by the spans, each span timed on the card
    (run where there is a card: ``python -m pytest rtbench/tests -m
    gpu``)."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.utils import profiling
    cell = harness.Cell(CELL, bench)
    drv = harness.driver_of(cell).Driver(cell, SEED, cuda, tracing.Spans())
    drv.setup()
    mk.reset_launch_counts()
    profiling.clear()
    profiling.enable()
    try:
        drv.unit()
    finally:
        profiling.disable()
    got = {k: mk.LAUNCHES[k] for k in ("mega_window", "mega_f2b",
                                       "mega_stream", "mega_regroup",
                                       "mega_trace")}
    assert got == {"mega_window": 145, "mega_f2b": 145, "mega_stream": 145,
                   "mega_regroup": 116, "mega_trace": 0}
    recs = profiling.records()
    profiling.clear()
    windows = [r for r in recs if r["name"] == "mega.window"]
    regroups = [r for r in recs if r["name"] == "mega.regroup"]
    assert len(windows) == 145 and len(regroups) == 116
    assert [(w["attrs"]["step_lo"], w["attrs"]["steps"])
            for w in windows[:5]] == [(0, 2), (2, 2), (4, 2), (6, 2), (8, 1)]
    assert sum(w["attrs"]["rays"] for w in windows) == 5 * 1280 * 720 * 8
    assert all(r["device_ms"] is not None and r["device_ms"] > 0.0
               for r in windows + regroups)
