"""The readings that the check's limits are set from, on the card, one
process for many seeds:

    python3 rtbench/controls.py --workload <cell> --seeds 11 12 13 \
        [--seconds 2] [--control] [--fault unchanged|half_batch|pixel_step]

For each seed: the cell's set-up and a short window at its own load, then
the numbers the check compares for the program (sound, or with the fault
planted underneath), and with ``--control`` the same numbers for the
reference put in the program's place in bfloat16 (the precision below the
configuration's float32).  One JSON line per seed on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtbench import faults, harness, tracing  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("controls.py needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload,
                        harness.load_json(harness.ROOT / "BENCHMARK.json"))
    dev = torch.device("cuda:0")
    for seed in args.seeds:
        t0 = time.perf_counter()
        fault = (faults.FAULTS[args.fault]() if args.fault
                 else contextlib.nullcontext())
        with fault:
            drv = harness.driver_of(cell).Driver(cell, seed, dev,
                                                 tracing.Spans())
            drv.setup()
            window = harness.measure(drv, args.seconds)
        harness.free_for_reference(drv)
        t1 = time.perf_counter()
        out = {"workload": args.workload, "seed": seed,
               "fault": args.fault, "items": window.items,
               "program": drv.check(torch.float32)}
        t2 = time.perf_counter()
        if args.control:
            out["control"] = drv.control(torch.bfloat16)
        out["seconds"] = {"setup_window": t1 - t0, "check": t2 - t1,
                          "control": time.perf_counter() - t2}
        print(json.dumps(out), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
