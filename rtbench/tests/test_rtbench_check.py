"""The check that decides ``correct`` fails what it must: the control (the
reference in bfloat16 put in the program's place) and the faults planted
in the program underneath a run, each under the cell's own limits, at a
size the CPU holds.  The sound program passes the same limits."""

import pytest
import torch

from rtbench import faults, harness, tracing

CELLS = ["one_weekend.render", "one_weekend.fit"]
# the faults each cell can have (the exchange between chips: none is on
# more than one chip)
FAULTS = [("one_weekend.render", "pixel_step"),
          ("one_weekend.fit", "unchanged"),
          ("one_weekend.fit", "half_batch"),
          ("one_weekend.fit", "first_step_replayed")]
SEED = 2 ** 33 + 77


def failing(cell, items) -> bool:
    lim = cell.spec["limits"]
    return any(not (item[k] <= lim[k]) for item in items for k in lim)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_cells_limits(name, tiny):
    cell = tiny(name)
    drv = harness.driver_of(cell).Driver(cell, SEED, torch.device("cpu"),
                                         tracing.Spans())
    drv.setup()
    drv.unit()
    assert not failing(cell, drv.check(torch.float32))
    assert failing(cell, drv.control(torch.bfloat16))


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(name, fault, tiny):
    cell = tiny(name)
    # a window of a few units, so that the fit checks a step after its
    # first
    assert harness.run_cell(cell, SEED, 0.5, False, "cpu")["correct"]
    with faults.FAULTS[fault]():
        line = harness.run_cell(cell, SEED, 0.5, False, "cpu")
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card(cuda, bench):
    """One short run of the first cell on the card (run where there is
    one: ``python -m pytest rtbench/tests -m gpu``)."""
    cell = harness.Cell("one_weekend.render", bench)
    line = harness.run_cell(cell, 12345, 1.0, False, cuda)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
