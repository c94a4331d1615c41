"""Fixtures of the benchmark's own tests (``python -m pytest
rtbench/tests``): tiny cells on the CPU, and the card for the tests marked
``gpu``, which skip here with a reason."""

from __future__ import annotations

import copy

import pytest
import torch

from rtbench import harness

TINY = {
    "one_weekend.render": {"render": {"width": 48, "height": 27,
                                      "samples": 4, "ray_chunk": 2048},
                           "picks": 256},
    "one_weekend.fit": {"render": {"width": 24, "height": 16, "samples": 2,
                                   "ray_chunk": 4096, "engine": "wavefront"}},
}


@pytest.fixture(scope="session")
def bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def tiny_cell(bench, name: str) -> harness.Cell:
    """The cell at a size the CPU runs in seconds: a few pixels, few
    samples."""
    cell = harness.Cell(name, bench)
    cell.spec = copy.deepcopy(cell.spec)
    cell.config = copy.deepcopy(cell.config)
    for k, v in TINY[name].items():
        if isinstance(v, dict):
            cell.spec[k] = {**cell.spec.get(k, {}), **v}
        else:
            cell.spec[k] = v
    return cell


@pytest.fixture
def tiny(bench):
    return lambda name: tiny_cell(bench, name)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels run only there)")
    return torch.device("cuda:0")
