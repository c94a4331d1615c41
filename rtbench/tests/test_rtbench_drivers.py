"""The drivers repeat for a seed: the same seed gives the same frames and
the same fit steps, so every run of a seed does the same work, and the
fit's check compares the window's last step beside its first."""

import numpy as np
import torch

from rtbench import harness, tracing


def test_render_and_fit_drivers_repeat_for_a_seed(tiny):
    for name in ("one_weekend.render", "one_weekend.fit"):
        outs = []
        for _ in range(2):
            cell = tiny(name)
            drv = harness.driver_of(cell).Driver(cell, 17, torch.device(
                "cpu"), tracing.Spans())
            drv.setup()
            drv.unit()
            outs.append(drv.kept if name.endswith("render")
                        else drv.program_runs())
        if name.endswith("render"):
            assert np.array_equal(outs[0][0], outs[1][0])
        else:
            assert outs[0] == outs[1]


def test_the_fit_checks_its_first_and_its_last_step(tiny):
    cell = tiny("one_weekend.fit")
    drv = harness.driver_of(cell).Driver(cell, 2 ** 34 + 5, torch.device(
        "cpu"), tracing.Spans())
    drv.setup()
    for _ in range(3):
        drv.unit()
    assert [k for k, _ in drv.checked()] == [0, 3]
    k, before, _, after = drv.record["last"]
    assert k == 3 and not torch.equal(before["centers"], after["centers"])
    items = drv.check(torch.float32)
    assert len(items) == 2
    lim = cell.spec["limits"]
    assert all(item[key] <= lim[key] for item in items for key in lim)
