"""The parallel layer's entry points on the CPU, each a tiny run over gloo
ranks: the multi-rank dry run (``parallel/dryrun.py``, whose own asserts
hold mega against the wavefront and sample-parallel against the members'
mean within 3e-4) and ``apps/scaling.py`` (valid JSON at ``--out``), and
``utils/profiling``."""

import json

import numpy as np
import pytest
import torch

from cudaraytracer_tpu_torch.apps import scaling
from cudaraytracer_tpu_torch.parallel.dryrun import TOL, dryrun_multichip
from cudaraytracer_tpu_torch.utils import profiling
from _torch_threads import one_intra_op_thread  # noqa: F401


def test_dryrun_multichip_four_ranks(capsys):
    out = dryrun_multichip(4, "cpu")
    assert out["mesh"] == {"dp": 2, "tp": 2}
    assert out["mega_vs_wavefront"] < TOL
    assert out["sample_parallel_vs_single"] < TOL
    assert np.isfinite(out["loss"]) and out["loss"] > 0.0
    assert out["img"].shape == (48, 96, 3)
    assert float(out["img"].mean()) > 0.05
    assert "dryrun_multichip(4)" in capsys.readouterr().out


def test_scaling_writes_json(tmp_path, capsys):
    path = tmp_path / "scaling.json"
    assert scaling.main(["--cpu", "--out", str(path), "--devices", "2",
                         "--width",
                         "16", "--height", "8", "--depth", "2", "--iters",
                         "1"]) == 0
    report = json.loads(path.read_text())
    assert set(report["render_strong_scaling"]) == {"dp1", "dp2"}
    assert set(report["render_strong_scaling_mega"]) == {"dp1", "dp2"}
    for v in report["render_strong_scaling"].values():
        assert v["sec_per_frame"] > 0.0
    assert set(report["fit_step"]) == {"posthoc_pmean", "overlapped"}
    assert report["fit_step"]["overlapped"]["mesh"] == {"dp": 1, "tp": 2}
    assert "measure no scaling" in report["note"]
    assert json.loads(capsys.readouterr().out.splitlines()[-2]) == report
    if not torch.cuda.is_available():
        # without --cpu it runs on the card, and raises without one
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scaling.main(["--out", str(tmp_path / "card.json")])
        assert not (tmp_path / "card.json").exists()


def test_profiling_timer_and_trace(tmp_path):
    profiling.clear()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        for _ in range(2):
            with profiling.span("work", rays=8):
                torch.ones(64).cumsum(0)
    assert any(e.key == "work" for e in prof.key_averages())
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert sum(e.get("name") == "work" and e.get("cat") == "user_annotation"
               for e in doc["traceEvents"]) == 2
    s = profiling.summary()["work"]
    assert s["count"] == 2 and s["host_ms"] > 0.0 and s["device_ms"] is None
    assert [r["attrs"] for r in profiling.records()] == [{"rays": 8}] * 2
    with profiling.span("untraced"):
        pass
    assert "untraced" not in profiling.summary()
    profiling.clear()
