#!/usr/bin/env python3
"""A/B of the port's fast5 reader (``read_tombo_fast5``,
deepsignal_plant_tpu_torch/io/fast5.py) between this checkout and
another (say, the parent commit unpacked with ``git archive``): reads/s
of each tree on the same files, the trees in turns (this, other, other,
this), each pass a fresh process. Host work only: no card is used.

    python3 fast5_reader_ab.py OTHER_TREE [--reads 256] [--repeat 100]

Files: a run of ``--reads`` single-read tombo fast5s of 5,000 bases with
contiguous signals, written by this checkout's writer (chip_smoke.py's
phase 6 run), and each committed feature fixture
(tests/data/fast5_features/) read ``--repeat`` times. A tree that
refuses a file set reports its error instead of a rate. The last line
is one JSON object: each tree's reads/s per file set in each pass.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from deepsignal_plant_tpu_torch.io import fast5
out = {}
for name, files in json.loads(sys.argv[2]).items():
    try:
        for p in files[:4]:                 # native library, page cache
            fast5.read_tombo_fast5(p)
        t = time.perf_counter()
        for p in files:
            fast5.read_tombo_fast5(p)
        out[name] = len(files) / (time.perf_counter() - t)
    except Exception as exc:
        out[name] = f"{type(exc).__name__}: {exc}"[:200]
print(json.dumps(out))
"""


def run_pass(tree: str, sets: dict) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, tree,
                           json.dumps(sets)], capture_output=True, text=True,
                          timeout=600, cwd=tree)
    if proc.returncode != 0:
        raise SystemExit(f"the pass on {tree} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other tree (a checkout's root)")
    ap.add_argument("--reads", type=int, default=256)
    ap.add_argument("--repeat", type=int, default=100)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import chip_smoke
    from deepsignal_plant_tpu_torch.io import fast5
    trees = {"this": REPO, "other": os.path.abspath(args.other)}
    fixtures = chip_smoke.FEATURE_DIR
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        chip_smoke.write_fast5_run(fast5, run, args.reads,
                                   chip_smoke.FAST5_READ_LEN,
                                   chip_smoke.SEED + 11)
        sets = {"run_5kb": sorted(os.path.join(run, f)
                                  for f in os.listdir(run))}
        for f in sorted(os.listdir(fixtures)):
            if f.endswith(".fast5"):
                sets[f[:-len(".fast5")]] = [os.path.join(fixtures, f)] * \
                    args.repeat
        passes = []
        for name in ("this", "other", "other", "this"):
            rates = run_pass(trees[name], sets)
            passes.append({"tree": name, "reads_per_s": rates})
            print(json.dumps(passes[-1]), flush=True)
    print(json.dumps({"trees": trees, "reads": args.reads,
                      "repeat": args.repeat, "passes": passes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
