#!/usr/bin/env python3
"""call_mods' end-to-end rate on one seeded features TSV, for one or more
checkouts of the port in turns, on one card.

    python3 call_mods_ab.py build/parent . . build/parent [--rows 131072]
    python3 call_mods_ab.py . --fixture sparse --wires auto off
    python3 call_mods_ab.py . --fixture dense sparse \
        --allocators tuned default default tuned [--tsv DENSE SPARSE]

Fixtures: ``dense`` (write_dense_features: read-structured, one site per
C, ~3.9 bases a site) or ``sparse`` (write_features: unrelated 13-base
windows). Each checkout given runs in a fresh process that imports its
own deepsignal_plant_tpu_torch and loads one seeded random full-width
both_bilstm checkpoint on the card (bf16, the layer kernel); then, for
each ``--wires`` entry in turn, it makes an engine with that
``--packed_wire`` (``default``: the checkout's own CallConfig) and runs
``rate_run``: the TSV once to warm up, once under torch.profiler. Each
process prints one JSON line per run; the last line is a JSON list of
them. The checkpoint comes from this checkout's init_params and
save_checkpoint, which every checkout of the port reads. Without a card
it fails.

Several ``--fixture`` entries run in each process in turn (``--tsv``
gives existing files for them instead of writing the fixtures).
``--allocators`` runs each checkout once per entry, each a fresh process:
``tuned`` as the package runs (glibc's malloc thresholds raised by
utils/allocator.py when the native library loads), ``default`` with
glibc's own thresholds, the package's tune replaced by a no-op before
anything loads (calling mallopt to restore 128 KB would not restore
them: a mallopt of M_MMAP_THRESHOLD turns off glibc's dynamic
threshold). Each run reports the sha256 of the rows it wrote.

chip_smoke.py imports the fixture writers, ``rate_run`` and
``run_child`` from here.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
T = 13


def write_features(path: str, n: int, seed: int, shift: float = 0.8) -> None:
    """A seeded 12-column features TSV, rows grouped by read, labels
    alternating (label = (pos / 10) % 2) with a shift of the means and
    signals by +-``shift``."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    labels = np.arange(n) % 2
    shift = np.where(labels == 1, shift, -shift)
    codes = rng.integers(0, 4, (n, T))
    codes[:, T // 2] = 1                                   # centre C
    means = np.around(shift[:, None] + rng.normal(0, 0.3, (n, T)), 6)
    stds = np.around(np.abs(rng.normal(0.5, 0.1, (n, T))), 6)
    lens = rng.integers(3, 30, (n, T))
    sig = np.around(shift[:, None, None] + rng.normal(0, 0.5, (n, T, 16)), 6)
    with open(path, "w") as fh:
        for i in range(n):
            r = i // 20
            fh.write("\t".join([
                "chr1", str(10 * i), "+-"[r % 2], str(10 * i),
                f"read_{r:05d}", "t", "".join(bases[codes[i]]),
                ",".join(map(str, means[i].tolist())),
                ",".join(map(str, stds[i].tolist())),
                ",".join(map(str, lens[i].tolist())),
                ";".join(",".join(map(str, row)) for row in sig[i].tolist()),
                str(labels[i])]) + "\n")


def write_dense_features(path: str, n: int, seed: int, read_len: int = 2000,
                         shift: float = 0.8) -> None:
    """A seeded read-structured 12-column features TSV of ``n`` rows, as
    extraction writes them: per read a random base string and per-base
    means, stds, lens and 16-sample signal rows (numpy draws, one
    %-format per base or signal row); one row per C at least 6 bases from
    either end, about one every 4 bases, its 13-base window cut from the
    read, so adjacent rows share their bases' values. Labels alternate by
    read, with a shift of the means and signals by +-``shift``."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    nb = T // 2
    f6 = "%.6f".__mod__
    sig_fmt = ",".join(["%.6f"] * 16)
    rows = r = 0
    with open(path, "w") as fh:
        while rows < n:
            label = r % 2
            mu = shift if label else -shift
            codes = rng.integers(0, 4, read_len)
            seq = "".join(bases[codes])
            means = list(map(f6, (mu + rng.normal(0, 0.3, read_len))
                             .tolist()))
            stds = list(map(f6, np.abs(rng.normal(0.5, 0.1, read_len))
                            .tolist()))
            lens = list(map(str, rng.integers(3, 30, read_len).tolist()))
            sig = [sig_fmt % tuple(x) for x in
                   (mu + rng.normal(0, 0.5, (read_len, 16))).tolist()]
            sites = np.nonzero(codes[nb:read_len - nb] == 1)[0][:n - rows]
            strand, name = "+-"[r % 2], f"read_{r:05d}"
            out = []
            for c in (sites + nb).tolist():
                w = slice(c - nb, c + nb + 1)
                pos = str(1_000_000 * r + c)
                out.append("\t".join([
                    "chr1", pos, strand, pos, name, "t", seq[w],
                    ",".join(means[w]), ",".join(stds[w]), ",".join(lens[w]),
                    ";".join(sig[w]), str(label)]))
            fh.write("\n".join(out) + "\n")
            rows += len(sites)
            r += 1


FIXTURES = {"dense": write_dense_features, "sparse": write_features}


def busy_seconds(prof) -> tuple[float, int]:
    """The union of a torch.profiler run's device spans (kernels and
    copies) in seconds, and the number of spans."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy = 0.0
    if spans:
        cur_s, cur_e = spans[0]
        for s0, e0 in spans[1:]:
            if s0 > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s0, e0
            else:
                cur_e = max(cur_e, e0)
        busy += cur_e - cur_s
    return busy / 1e6, len(spans)


def rate_run(engine, tsv: str, out: str, launches: dict) -> dict:
    """``engine.run_features_file`` on ``tsv`` to warm up (CUDA's
    first-use costs, the pinned ring grown to full batches, the file in
    the page cache), then once more under torch.profiler with CUDA
    activity only: the rate from that run's CallStats, the card's busy
    share (the union of its kernel and copy spans over the run's wall
    time), and the kernel launches of that run (``launches``, the
    checkout's counters, set to 0 just before it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    engine.run_features_file(tsv, out)
    for k in launches:
        launches[k] = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = engine.run_features_file(tsv, out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, events = busy_seconds(prof)
    return {"stats": dataclasses.asdict(stats),
            "sites_per_s": stats.sites / stats.seconds,
            "kernel_launches": dict(launches),
            "profiled_wall_seconds": wall, "busy_seconds": busy,
            "busy_share": busy / wall if events else None,
            "device_events": events}


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def child(tree: str, inputs: list[tuple[str, str]], ckpt: str, tmp: str,
          wires: list[str], arm: str) -> list[dict]:
    """One checkout's runs, in this process: at each wire, one engine
    on each (fixture, TSV) of ``inputs``, under allocator ``arm``."""
    sys.path.insert(0, tree)
    try:
        from deepsignal_plant_tpu_torch.utils import allocator
    except ImportError:         # a checkout from before the tune
        allocator = None
    if allocator is not None:
        if arm == "default":
            allocator.tune_host_allocator = lambda: False
        else:
            allocator.tune_host_allocator()
    from deepsignal_plant_tpu_torch.config import CallConfig, ModelConfig
    from deepsignal_plant_tpu_torch.ops import fused_lstm
    from deepsignal_plant_tpu_torch.pipeline.call_mods import CallModsEngine
    cfg = ModelConfig(dropout_rate=0.0, compute_dtype="bfloat16")
    out = []
    for wire in wires:
        call = CallConfig() if wire == "default" else CallConfig(
            packed_wire=wire)
        eng = CallModsEngine(ckpt, cfg, call, device="cuda")
        for fixture, tsv in inputs:
            path = os.path.join(tmp, f"calls_{os.getpid()}.tsv")
            res = rate_run(eng, tsv, path, fused_lstm.launches)
            out.append({"tree": tree, "fixture": fixture, "wire": wire,
                        "allocator": arm, "allocator_tuned": bool(
                            allocator is not None and allocator._tuned),
                        "rows_sha256": file_sha256(path), **res})
            os.remove(path)
    return out


def run_child(tree: str, inputs: list[tuple[str, str]], ckpt: str,
              tmp: str, wires: list[str], arm: str) -> list[dict]:
    """``child``'s runs in a fresh process at ``tree`` (its own imports,
    CUDA start and allocator state); raises if the process fails."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), os.path.abspath(tree),
         "--child", json.dumps(inputs), ckpt, tmp, arm, "--wires", *wires],
        cwd=tree, env=env, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} ({arm}) exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"tree"')]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts, in run order")
    ap.add_argument("--rows", type=int, default=131_072)
    ap.add_argument("--fixture", nargs="+", choices=sorted(FIXTURES),
                    default=["dense"])
    ap.add_argument("--tsv", nargs="+", help="existing TSVs, one for each "
                    "--fixture entry, used instead of writing them")
    ap.add_argument("--wires", nargs="+", default=["default"],
                    help="--packed_wire settings, run in this order in "
                         "each checkout's process (default: its own)")
    ap.add_argument("--allocators", nargs="+", choices=["tuned", "default"],
                    default=["tuned"], help="a process per entry and "
                    "checkout, in this order")
    ap.add_argument("--child", nargs=4, help=argparse.SUPPRESS,
                    metavar=("INPUTS", "CKPT", "TMP", "ARM"))
    args = ap.parse_args()
    if args.child:
        inputs, ckpt, tmp, arm = args.child
        for res in child(args.trees[0], json.loads(inputs), ckpt, tmp,
                         args.wires, arm):
            print(json.dumps(res), flush=True)
        return 0
    if args.tsv and len(args.tsv) != len(args.fixture):
        ap.error("--tsv takes one file for each --fixture entry")
    import torch
    if not torch.cuda.is_available():
        print("call_mods_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from deepsignal_plant_tpu_torch.config import ModelConfig
    from deepsignal_plant_tpu_torch.models.bilstm import init_params
    from deepsignal_plant_tpu_torch.models.convert import save_checkpoint
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = []
        for i, fixture in enumerate(args.fixture):
            if args.tsv:
                inputs.append((fixture, os.path.abspath(args.tsv[i])))
                continue
            tsv = os.path.join(tmp, f"{fixture}.tsv")
            t0 = time.time()
            FIXTURES[fixture](tsv, args.rows, SEED + 6)
            print(f"wrote {args.rows} {fixture} rows "
                  f"({os.path.getsize(tsv)} bytes) in "
                  f"{time.time() - t0:.2f} s", flush=True)
            inputs.append((fixture, tsv))
        cfg = ModelConfig(dropout_rate=0.0)
        ckpt = os.path.join(tmp, "both_bilstm.ckpt.npz")
        save_checkpoint(ckpt, init_params(cfg, SEED), cfg)
        for tree in args.trees:
            for arm in args.allocators:
                try:
                    runs = run_child(tree, inputs, ckpt, tmp, args.wires,
                                     arm)
                except RuntimeError as exc:
                    print(exc, file=sys.stderr)
                    return 1
                for res in runs:
                    res["card"] = smi
                    print(json.dumps(res), flush=True)
                    results.append(res)
    print(json.dumps([{k: r[k] for k in (
        "tree", "fixture", "wire", "allocator", "sites_per_s", "busy_share",
        "rows_sha256")} for r in results]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
