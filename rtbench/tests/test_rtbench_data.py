"""The benchmark is data: BENCHMARK.json keeps the contract's shape, every
cell, configuration, driver and metric it names is a file found by its
name, and a new cell and a new metric are picked up from new files alone."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import torch

from rtbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "rtbench/run.py"]
    assert bench["paths"] == ["rtbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        assert c["file"].startswith("rtbench/") and (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        moved = next(x for x in bench["end_to_end"]
                     if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for cell in cells:
        reports = [m for m in bench["end_to_end"]
                   if cell in m.get("workloads", cells)]
        assert len(reports) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_every_named_part_is_a_file_of_its_own(bench):
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], bench)
        assert harness.driver_of(cell).Driver
        for m in cell.end_to_end:
            assert harness.stat_of(cell, m["name"])["stat"]
        for m in cell.per_layer:
            assert callable(harness.reader_of(cell, m["name"]).read)
        assert set(cell.spec["limits"])


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "rtbench").rglob("*")) if p.is_file()}


def test_a_new_cell_and_metric_come_from_new_files_alone(tmp_path, tiny):
    """A scratch copy gains a cell (a new traffic of an existing driver)
    and a per-layer metric (a reader and its data) by adding files and
    BENCHMARK.json entries; no file under rtbench/ changes, and a run of
    the new cell reports the new metric."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = json.loads((ROOT / "rtbench/workloads/one_weekend.render.json")
                      .read_text())
    spec["render"] = {"width": 32, "height": 18, "samples": 2,
                      "ray_chunk": 512}
    spec["picks"] = 64
    (tmp_path / "rtbench/workloads/one_weekend.small.json").write_text(
        json.dumps(spec))
    (tmp_path / "rtbench/metrics/frame.host_ms.py").write_text(
        "def read(ctx):\n"
        "    return ctx.spans.mean(ctx.data['span']) * 1e3\n")
    (tmp_path / "rtbench/metrics/frame.host_ms.json").write_text(
        json.dumps({"span": "frame"}))
    bench["workloads"].append({"name": "one_weekend.small",
                               "config": "one_weekend", "traffic": "small",
                               "chips": 1, "why": "a tiny frame"})
    bench["end_to_end"][0]["workloads"].append("one_weekend.small")
    bench["per_layer"].append({
        "name": "frame.host_ms", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "Entry", "moves": "frame_s",
        "workloads": ["one_weekend.small"]})
    new = {p.relative_to(tmp_path).as_posix()
           for p in (tmp_path / "rtbench").rglob("*") if p.is_file()}
    assert before == {k: v for k, v in _digest(tmp_path).items()
                      if k in before}
    assert len(new) == len(before) + 3
    cell = harness.Cell("one_weekend.small", bench, root=tmp_path)
    assert [m["name"] for m in cell.per_layer] == ["frame.host_ms"]
    line = harness.run_cell(cell, 5, 1e-3, True, "cpu")
    assert line["correct"]
    assert line["metrics"]["frame.host_ms"]["unit"] == "ms"
    assert line["metrics"]["frame.host_ms"]["value"] > 0.0
    line = harness.run_cell(cell, 5, 1e-3, False, "cpu")
    assert set(line["metrics"]) == {"frame_s", "setup_s"}


def test_the_line_has_the_contract_keys(tiny):
    line = harness.run_cell(tiny("one_weekend.render"), 2 ** 40 + 3, 1e-3,
                            False, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_the_command_refuses_a_machine_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "one_weekend.render", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_forbidden_module_stops_the_run(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "cudaraytracer_tpu_torch.x",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
