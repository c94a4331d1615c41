"""The readers of the program's own spans: each gives its value on a
hand-made trace and records, and None where the program left no such
span (a checkout from before it); a traced run of each tiny cell reads
them from the program itself."""

import pytest

from cudaraytracer_tpu_torch.utils import profiling
from rtbench import harness, tracing


def _reader(name):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = next(w["name"] for w in bench["workloads"]
                if any(m["name"] == name and w["name"] in m["workloads"]
                       for m in bench["per_layer"]))
    return harness.reader_of(harness.Cell(cell, bench), name).read


class Ctx:
    def __init__(self, device, host, window=(0.0, 1000.0), items=2):
        ops = [tracing.Op(n, c, s, e) for n, c, s, e in device]
        hosts = [tracing.Op(n, "user_annotation", s, e) for n, s, e in host]
        self.trace = tracing.DeviceTrace(ops, hosts, window, items)
        self.spans, self.data = tracing.Spans(), None


def _records(monkeypatch, recs):
    monkeypatch.setattr(profiling, "records", lambda: [
        {"name": n, "device_ms": ms} for n, ms in recs])


def test_render_readers_on_a_made_up_trace():
    ctx = Ctx([("k", "kernel", 0.0, 900.0)],
              [("frame", 0, 1000), ("mega.tables", 10, 14),
               ("render.chunk", 20, 22), ("render.chunk", 30, 36),
               ("mega.tables", 500, 502)])
    # two chunks of 2 and 6 us; two frames, 6 us of tables
    assert _reader("render.chunk_host_ms")(ctx) == pytest.approx(4e-3)
    assert _reader("mega.tables_ms")(ctx) == pytest.approx(3e-3)


def test_fit_readers_on_a_made_up_trace(monkeypatch):
    # the device idles 100-200 (inside the backward) and 600-700 (not)
    ctx = Ctx([("k", "kernel", 0.0, 100.0), ("k", "kernel", 200.0, 600.0),
               ("k", "kernel", 700.0, 1000.0)],
              [("step", 0, 1000), ("fit.forward", 0, 50),
               ("fit.backward", 50, 400), ("fit.update", 650, 660)])
    _records(monkeypatch, [("fit.forward", 9.0), ("fit.backward", 99.0),
                           ("fit.forward", 2.0), ("fit.backward", 14.0)])
    # the newest record of each, as the trace holds one range of each
    assert _reader("fit.bwd_fwd_device_ratio")(ctx) == pytest.approx(7.0)
    assert _reader("device_idle.fit.backward")(ctx) == pytest.approx(10.0)
    _records(monkeypatch, [("fit.forward", 2.0), ("fit.backward", None)])
    assert _reader("fit.bwd_fwd_device_ratio")(ctx) is None
    # a program that keeps no records: the ranges give no device ms
    monkeypatch.delattr(profiling, "records")
    assert _reader("fit.bwd_fwd_device_ratio")(ctx) is None


@pytest.mark.parametrize("name", ["render.chunk_host_ms", "mega.tables_ms",
                                  "fit.bwd_fwd_device_ratio",
                                  "device_idle.fit.backward"])
def test_a_span_reader_finds_nothing_without_its_spans(monkeypatch, name):
    ctx = Ctx([("k", "kernel", 0.0, 10.0)], [("frame", 0, 1000),
                                              ("step", 0, 1000)])
    _records(monkeypatch, [("fit.forward", 1.0), ("fit.backward", 2.0)])
    assert _reader(name)(ctx) is None


@pytest.mark.parametrize("name,reads", [
    ("one_weekend.render", {"render.chunk_host_ms", "mega.tables_ms"}),
    # no CUDA events on the CPU: the device ratio reads nothing there
    ("one_weekend.fit", {"device_idle.fit.backward"}),
])
def test_a_traced_tiny_run_reads_the_programs_spans(tiny, name, reads):
    line = harness.run_cell(tiny(name), 7, 1e-3, True, "cpu")
    assert line["correct"]
    assert reads <= set(line["metrics"])
    assert all(line["metrics"][k]["value"] >= 0.0 for k in reads)
