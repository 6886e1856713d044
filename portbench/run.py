#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the machine it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` (the window's sites), ``failed`` (rows that fail the
comparison), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared and its limit,
which also end standard error. Exits 2, printing no result, without a
CUDA card or with fewer than the cell asks for, and 3 when JAX or the
JAX package was loaded.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder: imports name portbench.<module>
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or ".") != os.path.dirname(
                   os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

#: top-level modules that no run may load (compared whole: the port's
#: name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "deepsignal_plant_tpu")


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.lib import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        return 2
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T0)
    harness.stop_resource_tracker()
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": run.metrics,
           "device": run.device}
    if run.breakdown is not None:
        out["breakdown"] = run.breakdown
    out["checks"] = run.checks
    rec = run.record
    print("portbench: {} passes of {} sites, pass seconds {}, set-up marks "
          "{}, input bytes {}, run seconds {:.1f}".format(
              rec["passes"], rec["sites"] // max(rec["passes"], 1),
              [round(s, 4) for s in rec["pass_seconds"]],
              {k: round(v, 3) for k, v in rec["setup_marks"].items()},
              rec["input_bytes"], time.time() - T0), file=sys.stderr)
    print("portbench: the window's CPU seconds a second {:.4f}, the "
          "children's it reaped {:.3f}; the main thread's seconds a pass "
          "waiting for input {:.4f}, emitting rows {:.4f}".format(
              rec["cpu_s"] / rec["window_s"], rec["children_cpu_s"],
              rec["stats"].get("parse_wait_seconds", 0.0)
              / max(rec["passes"], 1),
              rec["stats"].get("format_seconds", 0.0)
              / max(rec["passes"], 1)), file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
