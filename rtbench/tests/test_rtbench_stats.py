"""The metric arithmetic: rates over a window, percentiles over all items,
the union of device intervals, roofline shares."""

import re

import pytest

from rtbench import harness, stats, tracing
from rtbench.metrics import _read


def test_window_rate_is_all_the_window_over_all_items():
    w = harness.Window()
    w.seconds, w.items, w.item_s = 10.0, 40, [0.1] * 40
    assert harness.end_to_end_value("window_per_item", w, 3.0) == 0.25
    assert harness.end_to_end_value("setup", w, 3.0) == 3.0
    with pytest.raises(ValueError):
        stats.per_item(1.0, 0)


def test_p95_is_over_every_item():
    values = list(range(1, 101))            # 1 .. 100
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    assert stats.percentile(values, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    w = harness.Window()
    w.seconds, w.items, w.item_s = 1.0, 100, [float(v) for v in values]
    assert harness.end_to_end_value("item_p95", w, 0.0) == pytest.approx(
        95.05)


@pytest.mark.parametrize("intervals,lo,hi,want", [
    ([(0, 2), (1, 3), (5, 6)], None, None, 4.0),
    ([(0, 2), (2, 3)], None, None, 3.0),
    ([(0, 10)], 2, 4, 2.0),
    ([(5, 6), (0, 1)], 0.5, 5.5, 1.0),
    ([], None, None, 0.0),
])
def test_union_of_intervals(intervals, lo, hi, want):
    assert stats.union_seconds(intervals, lo, hi) == pytest.approx(want)


def test_gaps_are_the_uncovered_stretches():
    assert stats.gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [
        (0, 1), (3, 4), (5, 6)]
    assert stats.gaps([(0, 6)], 0, 6) == []


def test_roofline_share_from_a_frozen_count():
    # 67 GFLOP at 67 TFLOP/s is 1 ms; 3.35 GB at 3.35 TB/s is 1 ms
    b, by = stats.bound_seconds(67e9, 1e9, 67e12, 3.35e12)
    assert (b, by) == (pytest.approx(1e-3), "operations")
    b, by = stats.bound_seconds(1e9, 6.7e9, 67e12, 3.35e12)
    assert (b, by) == (pytest.approx(2e-3), "bytes")
    assert stats.roofline_share(1e-3, 4e-3) == pytest.approx(25.0)
    assert stats.roofline_share(1e-3, 0.0) is None


def _trace(ops, window=(0.0, 1e6), items=2):
    return tracing.DeviceTrace(
        [tracing.Op(n, c, s, e) for n, c, s, e in ops],
        [tracing.Op("frame", "user_annotation", 0.0, 1e6)], window, items)


def test_readers_on_a_made_up_trace():
    t = _trace([("void crt::mega_path<false>(crt::Params)", "kernel", 0,
                 2e5),
                ("elementwise", "kernel", 3e5, 4e5),
                ("Memcpy DtoH", "gpu_memcpy", 5e5, 6e5)])
    assert t.busy_s() == pytest.approx(0.4)
    assert t.window_s == pytest.approx(1.0)
    assert t.kernel_seconds(re.compile("mega_path")) == pytest.approx(0.2)

    class Ctx:
        trace, spans = t, tracing.Spans()
        data = {"kernel_pattern": "mega_path", "flops_per_item": 67e9,
                "bytes_per_item": 0.0}

    # 1 ms of work an item against 100 ms of K1 an item
    assert _read.roofline(Ctx) == pytest.approx(1.0)
    assert _read.launches_per_item(Ctx) == 1.0
    assert _read.idle_share(Ctx) == pytest.approx(60.0)
    Ctx.data = None
    assert _read.roofline(Ctx) is None
    bd = t.breakdown()
    assert bd["device_ops"][0][0].startswith("void crt::mega_path")
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(0.6)
    assert bd["idle_gaps"][0][0] == "frame"


def test_a_reader_finds_nothing_in_an_empty_trace():
    class Ctx:
        trace, spans, data = _trace([]), tracing.Spans(), {}

    assert _read.launches_per_item(Ctx) is None
    assert _read.idle_share(Ctx) is None

