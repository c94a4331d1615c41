"""The harness: one cell, one run.

``run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``:

1. finds the cell in ``BENCHMARK.json`` and its files by name: the cell
   ``rtbench/workloads/<cell>.json``, its configuration (the file
   ``BENCHMARK.json`` names), its driver ``rtbench/drivers/<driver>.py``,
   each end-to-end metric's statistic ``rtbench/metrics/<name>.json`` and
   each per-layer metric's reader ``rtbench/metrics/<name>.py``;
2. has the driver make the cell's inputs from the seed and warm up the
   cell's own shapes (set-up, timed from the process's start);
3. measures for ``--seconds``: the driver's units (a frame, a step)
   back to back, whole units, the window ending with the last one;
4. with ``--trace 1``, traces a few more units with ``torch.profiler`` and
   has each per-layer metric's reader read the spans and the trace;
5. checks what the window produced against the plain reference
   (``rtbench/reference``), after the program's state is freed, and prints
   one JSON line.

``run_cell`` runs a cell on any device (the CPU tests run it on the CPU
at small sizes); ``main`` is the command, which refuses to run without as
many CUDA cards as the cell asks for.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "cudaraytracer_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell as its files give it: ``entry`` (its line in BENCHMARK.json),
    ``spec`` (its workload file), ``config`` (its configuration's file),
    and the metrics it reports."""

    def __init__(self, name: str, bench: dict, root: Path = ROOT):
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if len(entries) != 1:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[0]
        self.root = root
        self.spec = load_json(root / "rtbench" / "workloads" / f"{name}.json")
        configs = [c for c in bench["configs"]
                   if c["name"] == self.entry["config"]]
        self.config = load_json(root / configs[0]["file"])

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        self.end_to_end = mine(bench["end_to_end"])
        self.per_layer = mine(bench["per_layer"])

    @property
    def settings(self) -> dict:
        """The render settings: the configuration's, then the cell's."""
        return {**self.config["render"], **self.spec.get("render", {})}


def stat_of(cell: Cell, name: str) -> dict:
    return load_json(cell.root / "rtbench" / "metrics" / f"{name}.json")


def reader_of(cell: Cell, name: str):
    path = cell.root / "rtbench" / "metrics" / f"{name}.py"
    return load_module(path, "rtbench_metric_" + name.replace(".", "_"))


def driver_of(cell: Cell):
    """The module ``rtbench.drivers.<the cell's driver>``."""
    return importlib.import_module(f"rtbench.drivers.{cell.spec['driver']}")


class Window:
    """What a window measured: its seconds, the items (frames or steps)
    completed, each item's own seconds."""

    def __init__(self):
        self.seconds = 0.0
        self.items = 0
        self.item_s: list = []


def measure(driver, seconds: float) -> Window:
    """The driver's units back to back until ``seconds`` have passed; the
    unit running at the deadline completes and counts."""
    w = Window()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        item_s = driver.unit()
        w.items += len(item_s)
        w.item_s += item_s
    w.seconds = time.perf_counter() - start
    return w


def end_to_end_value(stat: str, window: Window, setup_s: float) -> float:
    from . import stats
    if stat == "setup":
        return setup_s
    if stat == "window_per_item":
        return stats.per_item(window.seconds, window.items)
    if stat.startswith("item_p"):
        return stats.percentile(window.item_s, float(stat[len("item_p"):]))
    raise ValueError(f"unknown end-to-end statistic {stat!r}")


class ReaderContext:
    """What a per-layer metric's reader reads: the window's spans, the
    trace of the traced units, the metric's own data file (or None)."""

    def __init__(self, spans, trace, data):
        self.spans = spans
        self.trace = trace
        self.data = data


def forbidden_modules() -> list:
    """The forbidden top-level module names that this process holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: Optional[float] = None) -> dict:
    """Run ``cell`` once on ``device`` -> the result line's dict.  t0: the
    process's start on the host clock (set-up counts from it)."""
    import torch

    from . import tracing
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    spans = tracing.Spans()
    drv = driver_of(cell).Driver(cell, seed, dev, spans)
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    spans.times.clear()
    window = measure(drv, seconds)
    metrics, breakdown, device_info = {}, None, {}
    if dev.type == "cuda":
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(dev),
                       "count": int(cell.entry["chips"]),
                       "memory_peak_bytes":
                           int(torch.cuda.max_memory_allocated(dev))}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": 0}
    if not trace:
        for m in cell.end_to_end:
            stat = stat_of(cell, m["name"])["stat"]
            metrics[m["name"]] = {"value": end_to_end_value(stat, window,
                                                            setup_s),
                                  "unit": m["unit"]}
    else:
        drv.extra_spans()
        window_spans = spans.snapshot()
        dt = tracing.traced(lambda: [x for _ in range(drv.traced_units)
                                     for x in drv.unit()], len)
        if dev.type == "cuda" and not dt.kernels():
            raise RuntimeError("the profiler saw no device kernel in the "
                               "traced units: no device metric can be read")
        device_info["busy_s"] = dt.busy_s()
        device_info["window_s"] = dt.window_s
        breakdown = dt.breakdown()
        for m in cell.per_layer:
            data_path = cell.root / "rtbench" / "metrics" / f"{m['name']}.json"
            data = load_json(data_path) if data_path.exists() else None
            value = reader_of(cell, m["name"]).read(
                ReaderContext(window_spans, dt, data))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                # a kernel taken off the path leaves its roofline silent;
                # say which, and what its reader looked for
                what = (data or {}).get("kernel_pattern", "its spans")
                print(f"rtbench: {m['name']} read nothing in "
                      f"{cell.name} (it looks for {what!r})",
                      file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {found} after the window")
    numbers = check_numbers(cell, drv)
    return finish_line(window, metrics, device_info, breakdown, numbers)


def free_for_reference(drv) -> None:
    """Free the program's state (the peak memory has been read) and keep
    the reference's float32 matmuls in float32."""
    import torch
    drv.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_numbers(cell: Cell, drv) -> list:
    """[(name, value, limit)] of each checked item: the program's answers
    against the reference's, worked out once the program's state is
    freed."""
    import torch
    free_for_reference(drv)
    limits = cell.spec["limits"]
    out = []
    for item in drv.check(torch.float32):
        out.append([(k, float(item[k]), float(limits[k])) for k in limits])
    return out


def finish_line(window, metrics, device_info, breakdown, numbers) -> dict:
    failed = sum(1 for item in numbers
                 if not all(math.isfinite(v) and v <= lim
                            for _, v, lim in item))
    worst = {}
    for item in numbers:
        for k, v, lim in item:
            prev = worst.get(k)
            if prev is None or not (v <= prev[0]):
                worst[k] = (v, lim)
    line = {"correct": bool(numbers) and failed == 0,
            "attempted": window.items, "failed": failed,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    # JSON has no infinity: a number that is not finite reads 1e300
    line["checks"] = {k: {"value": v if math.isfinite(v) else 1e300,
                          "limit": lim} for k, (v, lim) in worst.items()}
    return line


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(args.workload, bench)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rtbench: the cell needs {chips} CUDA card(s); this machine "
              f"has {n}", file=sys.stderr)
        return 3
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    "cuda:0", t0)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
