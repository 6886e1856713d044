#!/usr/bin/env python3
"""Readings that a cell's comparison limits are set from, in one process
on the chip (``run.py`` never plants anything; this does):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 10] [--seconds 1]

For each seed a run of the cell as ``run.py`` makes it (set-up, a short
window at the cell's own size, the comparison), with no limit applied:
- ``--seeds``: the program as it stands (the lower reading: the largest
  gap of sound runs);
- ``--control-seeds``: the plain reference in the workload's ``control``
  precision put in the program's place (the upper reading: the smallest);
- ``--fault-seeds``: each of lib/faults.py's faults in turn, then the
  faults that the cell's traffic kind exports as ``FAULTS``.
One JSON line a run, then a summary line.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or ".") != os.path.dirname(
                   os.path.abspath(__file__))]
sys.path.insert(0, ROOT)


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    import contextlib

    import torch

    from portbench import harness
    from portbench.lib import check, faults, spec

    cell = spec.load_cell(args.workload)
    # every gap read, whichever the cell limits
    cell.workload = {**cell.workload,
                     "limits": {g: math.inf for g in check.GAPS}}
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    plans = [("program", s, contextlib.nullcontext)
             for s in _seeds(args.seeds)]
    plans += [("control", s, lambda s=s: faults.control(
        cell.config, s, dev, cell.workload["control"]))
        for s in _seeds(args.control_seeds)]
    inputs = getattr(spec.load_module("traffic", cell.traffic["kind"]),
                     "FAULTS", {})
    for s in _seeds(args.fault_seeds):
        plans += [("half_batch", s, faults.half_batch),
                  ("altered_answer", s, faults.altered_answer),
                  ("dropped_rows", s, faults.dropped_rows)]
        plans += [(name, s, plant) for name, plant in inputs.items()]
    readings: dict[str, list] = {}
    for kind, seed, plant in plans:
        t0 = time.time()
        with plant():
            run = harness.run_cell(cell, seed, args.seconds, False, dev, t0)
        line = {"kind": kind, "seed": seed,
                **{k: c["value"] for k, c in run.checks.items()},
                "compared": run.record["rows_compared"],
                "passes": run.record["passes"],
                "sites_per_s": run.record["sites"]
                / run.record["window_s"],
                "setup_s": run.metrics["setup_s"]["value"],
                "device": run.device["kind"]}
        print(json.dumps(line), flush=True)
        for g in check.GAPS:
            readings.setdefault(g, {}).setdefault(kind, []).append(
                run.checks[g]["value"])
    harness.stop_resource_tracker()
    summary = {"workload": cell.name, **{g: {
        "lower": max(r.get("program", [math.nan])),
        "upper": min(r.get("control", [math.nan])), "readings": r}
        for g, r in readings.items()}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
