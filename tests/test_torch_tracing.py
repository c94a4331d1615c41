"""The port's spans (``utils/profiling.py``) on the CPU: off, a span is a
flag check and nothing else; on, spans nest with their attributes, on the
clock of the profiler's exported trace; and the render and the fit step
open the spans the benchmark's readers read."""

import json
import math
import time

import pytest
import torch

from cudaraytracer_tpu_torch.config import RenderConfig
from cudaraytracer_tpu_torch.models import presets
from cudaraytracer_tpu_torch.ops import render
from cudaraytracer_tpu_torch.parallel import train
from cudaraytracer_tpu_torch.utils import profiling
from _torch_threads import one_intra_op_thread  # noqa: F401

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def _by_id():
    return {r["id"]: r for r in profiling.records()}


def _children(recs, parent, name):
    return [r for r in recs.values()
            if r["parent"] == parent["id"] and r["name"] == name]


def _under(recs, root, name):
    """The records named ``name`` anywhere below ``root``."""
    out = []
    for r in recs.values():
        p = r["parent"]
        while p is not None and p != root["id"]:
            p = recs[p]["parent"] if p in recs else None
        if p == root["id"] and r["name"] == name:
            out.append(r)
    return out


def test_a_span_off_is_a_flag_check(monkeypatch):
    ranges, clocks = [], []
    real_range, real_clock = torch.profiler.record_function, time.time_ns
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: ranges.append(a) or real_range(*a))
    monkeypatch.setattr(time, "time_ns",
                        lambda: clocks.append(1) or real_clock())
    first = profiling.span("a", device="cpu", rays=4)
    with first:
        with profiling.span("b"):
            torch.ones(4).sum()
    assert profiling.span("c") is first         # one shared empty context
    assert ranges == [] and clocks == []
    assert profiling.records() == [] and profiling.summary() == {}
    profiling.enable()
    with profiling.span("on", rays=4):
        pass
    assert len(ranges) == 1 and len(clocks) == 2
    assert [(r["name"], r["attrs"]) for r in profiling.records()] == [
        ("on", {"rays": 4})]


def test_nested_spans_under_the_profiler():
    with torch.profiler.profile(activities=CPU):
        with profiling.span("outer", device="cpu", width=8):
            for k in range(2):
                with profiling.span("inner", step=k):
                    torch.ones(16).cumsum(0)
        with profiling.span("after"):
            pass
    with profiling.span("no profiler"):
        pass
    recs = profiling.records()
    assert [r["name"] for r in recs] == ["outer", "inner", "inner", "after"]
    outer = recs[0]
    assert outer["parent"] is None and outer["attrs"] == {"width": 8}
    assert [r["parent"] for r in recs[1:3]] == [outer["id"]] * 2
    assert [r["attrs"]["step"] for r in recs[1:3]] == [0, 1]
    assert recs[3]["parent"] is None
    for r in recs:
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] is None
    assert outer["start_ns"] <= recs[1]["start_ns"]
    assert recs[2]["end_ns"] <= outer["end_ns"]
    s = profiling.summary()
    assert s["inner"]["count"] == 2 and s["outer"]["count"] == 1
    assert s["inner"]["host_ms"] >= 0.0 and s["inner"]["device_ms"] is None


def test_records_sit_on_the_exported_traces_clock(tmp_path):
    with torch.profiler.profile(activities=CPU):     # the first range warms
        with profiling.span("warm-up"):
            pass
    profiling.clear()
    with profiling.trace(str(tmp_path)):
        for k in range(5):
            with profiling.span(f"s{k}"):
                torch.ones(256).cumsum(0)
                with profiling.span(f"t{k}"):
                    torch.ones(256).sum()
    doc = json.loads((tmp_path / "trace.json").read_text())
    base = doc["baseTimeNanoseconds"]
    ranges = {e["name"]: e for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"}
    recs = profiling.records()
    assert len(recs) == 10
    for r in recs:
        e = ranges[r["name"]]
        start = base + e["ts"] * 1e3
        end = start + e["dur"] * 1e3
        assert abs(r["start_ns"] - start) < 1e5, r["name"]
        assert abs(r["end_ns"] - end) < 1e5, r["name"]


def test_render_opens_a_table_build_and_a_span_a_chunk():
    scene, cam = presets.three_spheres(aspect=2.0, device="cpu")
    cfg = RenderConfig(width=16, height=8, samples=2, max_depth=2,
                       engine="mega", ray_chunk=64)
    rays = cfg.width * cfg.height * cfg.samples
    with torch.profiler.profile(activities=CPU):
        render.render_image(scene, cam, cfg)
    recs = _by_id()
    frame, = [r for r in recs.values() if r["name"] == "render.frame"]
    assert frame["attrs"] == {"width": 16, "height": 8, "spp": 2}
    tables, = _children(recs, frame, "mega.tables")
    assert tables["attrs"] == {"spheres": scene.n_spheres,
                               "triangles": scene.n_triangles}
    chunks = _children(recs, frame, "render.chunk")
    assert len(chunks) == math.ceil(rays / cfg.ray_chunk) == 4
    assert sum(c["attrs"]["rays"] for c in chunks) == rays
    for c in chunks:
        for name in ("render.camera_rays", "render.integrate"):
            inner, = _children(recs, c, name)
            assert inner["attrs"] == {"engine": "mega"}
        # the monolithic launch: one window of every bounce step
        integ, = _children(recs, c, "render.integrate")
        window, = _children(recs, integ, "mega.window")
        assert window["attrs"] == {"step_lo": 0, "steps": cfg.max_depth + 1,
                                   "rays": c["attrs"]["rays"]}
    assert len(_children(recs, frame, "render.finish")) == 2
    assert len(recs) == 1 + 1 + 4 * 4 + 2


def _small_field():
    """4 x 3 copies of the 1,280-triangle icosphere (15,360 triangles,
    above the resident ceiling, so the fused path streams segments) and a
    camera over them."""
    from cudaraytracer_tpu_torch.core.camera import make_camera
    from cudaraytracer_tpu_torch.models import check_scenes
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    pts, faces = check_scenes.icosphere(3)
    b = SceneBuilder()
    mat = b.materials.lambertian(color=(0.6, 0.5, 0.4))
    for i in range(4):
        for j in range(3):
            b.add_mesh(pts, faces, mat, position=(2.3 * (i - 2), 0.0,
                                                  -2.6 * j))
    scene = b.build("cpu")
    assert scene.n_triangles == 15360 > mk.MAX_VMEM_PRIMS
    cam = make_camera((0, 2.2, 3.2), (0, 0.35, -2.6), (0, 1, 0), 50.0, 2.0,
                      0.0, 10.0, device="cpu")
    return scene, cam


@pytest.mark.parametrize("route,knobs,windows,sorts", [
    ("phased", dict(compact_every=2, compact_octants=True,
                    mega_f2b_shells=8), [(0, 2), (2, 2), (4, 1)], 2),
    ("compact", dict(compact_after=1), [(0, 1), (1, 4)], 1),
])
def test_streamed_routes_open_a_window_span_a_window_and_one_a_sort(
        route, knobs, windows, sorts):
    """On a streamed triangle field, each compaction driver opens one
    ``mega.window`` a window (its steps and rays) and one ``mega.regroup``
    a sort of the keys, under the chunk's ``render.integrate``; and
    ``LAUNCHES["mega_regroup"]`` counts the sorts."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    scene, cam = _small_field()
    cfg = RenderConfig(width=8, height=4, samples=2, max_depth=4,
                       engine="mega", ray_chunk=32, **knobs)
    mk.reset_launch_counts()
    profiling.enable()
    render.render_image(scene, cam, cfg)
    recs = _by_id()
    chunks = [r for r in recs.values() if r["name"] == "render.chunk"]
    assert len(chunks) == 2
    for c in chunks:
        integ, = _children(recs, c, "render.integrate")
        got = _children(recs, integ, "mega.window")
        assert [(w["attrs"]["step_lo"], w["attrs"]["steps"])
                for w in got] == windows
        assert all(w["attrs"]["rays"] == 32 for w in got)
        regroups = _children(recs, integ, "mega.regroup")
        assert len(regroups) == sorts
        assert all(r["attrs"] == {"rays": 32} for r in regroups)
        # a sort comes between two windows
        assert sorted(r["id"] for r in got + regroups)[1::2] == [
            r["id"] for r in regroups]
    assert mk.LAUNCHES["mega_regroup"] == 2 * sorts
    mk.reset_launch_counts()
    assert mk.LAUNCHES["mega_regroup"] == 0


def test_fit_step_spans_the_forward_backward_and_recompute():
    scene, cam = presets.three_spheres(aspect=1.5, device="cpu")
    cfg = RenderConfig(width=9, height=6, samples=1, max_depth=2,
                       gamma=False)
    target = torch.rand(cfg.width * cfg.height, 3,
                        generator=torch.Generator().manual_seed(3))
    params = {"albedo": (scene.textures.color0 * 0.6 + 0.1)
              .requires_grad_(),
              "centers": (scene.spheres.center + 0.05).requires_grad_()}
    step = train.make_fit_step(scene, cam, cfg, lr=0.1)
    profiling.enable()
    step(params, target, torch.Generator().manual_seed(1))
    recs = _by_id()
    top, = [r for r in recs.values() if r["parent"] is None]
    assert top["name"] == "fit.step"
    assert [r["name"] for r in recs.values() if r["parent"] == top["id"]] \
        == ["fit.forward", "fit.backward", "fit.update"]
    fwd, = _children(recs, top, "fit.forward")
    bwd, = _children(recs, top, "fit.backward")
    bounces = cfg.max_depth + 1
    ahead = _under(recs, fwd, "wavefront.bounce")
    assert [b["attrs"]["step"] for b in ahead] == list(range(bounces))
    for b in ahead:
        assert len(_children(recs, b, "wavefront.intersect")) == 1
        assert len(_children(recs, b, "wavefront.shade")) == 1
    again = _under(recs, bwd, "wavefront.bounce")
    assert sorted(b["attrs"]["step"] for b in again) == list(range(bounces))
    assert len(_under(recs, fwd, "render.chunk")) == 1
