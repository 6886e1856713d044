"""One run of one cell: set-up, the measured window, the comparison and
the metrics. ``run.py`` checks for the chip and prints; the tests call
``run_cell`` on the CPU at small sizes.

Set-up: the weights from the seed on the device, saved as a ``.ckpt``;
the cell's input from the seed (its traffic kind); the entry built from
the checkpoint; one whole pass, which builds and warms every kernel and
shape the window uses. The window: whole passes back to back, ending
with the first that finishes after ``seconds``; the rate is all their
sites over all their time; where the cell has an end-to-end metric from
the device trace, the card's activity is recorded over the window in
every run. Each pass's rows go to a pipe whose reader
keeps what the comparison needs (lib/sink.py). After the window: the
memory peak, then the entry is freed, and the plain reference computes
the sampled sites.
"""
from __future__ import annotations

import contextlib
import gc
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import torch

from portbench.lib import check, peaks, sink, spec, weights
from portbench.lib import trace as tracing
from portbench.reference import bilstm as reference

#: sites a pass whose rows are compared with the reference, drawn from
#: the seed: enough for a widest gap that repeats from seed to seed, and
#: a reference shorter than the window
CHECK_SITES = 4096


@dataclass
class Run:
    correct: bool
    attempted: int
    failed: int
    metrics: dict                  # name -> {"value", "unit"}
    device: dict
    checks: dict                   # name -> {"value", "limit"}
    breakdown: dict | None = None
    record: dict = field(default_factory=dict)


def _sum_stats(stats: list[dict]) -> dict:
    """Numeric CallStats fields summed over passes."""
    out: dict = {}
    for st in stats:
        for k, v in st.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = out.get(k, 0) + v
    return out


def _settle(*paths: str) -> None:
    """Flush files (and a directory's files) to the disk, so that their
    write-back does not run inside the window."""
    for path in paths:
        files = ([os.path.join(path, f) for f in sorted(os.listdir(path))]
                 if os.path.isdir(path) else [path])
        for f in files:
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def cpu_seconds() -> tuple[float, float]:
    """The process's CPU seconds (its threads') and those of the child
    processes it has waited for."""
    t = os.times()
    return t.user + t.system, t.children_user + t.children_system


def stop_resource_tracker() -> None:
    """Stop, and wait for, the process that multiprocessing starts beside
    a program's spawned worker pool (the fast5 path's) to track its
    semaphores: left to notice this process's exit, it outlives it."""
    from multiprocessing import resource_tracker
    resource_tracker._resource_tracker._stop()     # a no-op when not running


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, sizes: dict | None = None,
             workroot: str | None = None) -> Run:
    """``sizes`` overrides traffic parameters (the tests' small inputs);
    ``t0`` is the process's start on the host clock. Any whole ``seed``
    works (taken modulo 2**64)."""
    seed = int(seed) % (1 << 64)
    cfg, wl = cell.config, cell.workload
    traffic = {**cell.traffic, **(sizes or {})}
    work = tempfile.mkdtemp(prefix="portbench-", dir=workroot)
    entry = rows = None
    marks = {"start": time.time() - t0}
    try:
        sd = weights.make(cfg, seed, device)
        ckpt = os.path.join(work, "model.ckpt")
        weights.save(sd, ckpt)
        marks["weights"] = time.time() - t0
        kind = spec.load_module("traffic", traffic["kind"])
        inp = kind.make(traffic, seed, work, CHECK_SITES)
        _settle(ckpt, inp.path)
        marks["input"] = time.time() - t0
        rows = sink.RowSink(work, inp.sample.index, inp.sites * 120)
        entry = spec.load_module("entries", wl["entry"]).build(
            cfg, wl.get("options", {}), ckpt, device)
        marks["entry"] = time.time() - t0
        entry.run_pass(inp.path, rows.path)
        rows.wait_pass()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.time() - t0
        marks["warmup"] = setup_s

        # an untraced run of a cell with a device-trace end-to-end metric
        # records the card's activity alone
        card = (not trace and device.type == "cuda" and any(
            m["source"] == "device_trace" for m in cell.end_to_end))
        prof = (tracing.profiler() if trace
                else tracing.device_profiler() if card
                else contextlib.nullcontext())
        stats = []
        with prof:
            with torch.profiler.record_function(tracing.WINDOW):
                c0 = cpu_seconds()
                w0 = time.perf_counter()
                while True:
                    with torch.profiler.record_function(tracing.PASS):
                        stats.append(entry.run_pass(inp.path, rows.path))
                    with torch.profiler.record_function(
                            tracing.OUTPUT_WAIT):
                        rows.wait_pass()
                    if time.perf_counter() - w0 >= seconds:
                        break
                window_s = time.perf_counter() - w0
                c1 = cpu_seconds()
        dev = device_info(device)
        if device.type == "cuda":
            dev["memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(device))
        reduced = (tracing.reduce(prof, spec.kernel_groups())
                   if trace else None)
        busy_s = (reduced["busy_s"] if trace
                  else tracing.busy_seconds(prof) if card else None)
        passes = rows.close()
        rows = None
        dtype = entry.compute_dtype
        summed = _sum_stats(stats)
        # the entry's own checks of the window (a fast5 entry's files that
        # the program failed to read), each with its limit
        own = entry.checks(summed) if hasattr(entry, "checks") else {}
        entry.close()
        entry = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        s = inp.sample
        logits, probs = reference.forward_in_blocks(sd, cfg, *(
            torch.from_numpy(a).to(device) for a in (
                s.kmer, s.means, s.stds, s.lens, s.signals)))
        logits, probs = (t.double().cpu().numpy() for t in (logits, probs))
        checks = check.compare(passes, inp.sites, s, probs[:, 1],
                               logits[:, 1] - logits[:, 0], wl["limits"])
        checks.numbers.update(own)
        sites = sum(st["sites"] for st in stats)
        record = {
            "cell": cell.name, "config": cfg, "dtype": dtype,
            "peak_flops": peaks.PEAK_FLOPS[dtype],
            "peak_bytes": peaks.PEAK_BYTES,
            "itemsize": peaks.ITEMSIZE[dtype],
            "setup_s": setup_s, "window_s": window_s, "sites": sites,
            "passes": len(stats), "stats": summed,
            "trace": reduced, "device_busy_s": busy_s,
            "input_bytes": inp.bytes_written,
            "rows_compared": checks.compared, "setup_marks": marks,
            "pass_seconds": [st["seconds"] for st in stats],
            "cpu_s": c1[0] - c0[0], "children_cpu_s": c1[1] - c0[1]}
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            v = spec.load_module("metrics", m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = None
        if reduced is not None:
            dev["busy_s"] = reduced["busy_s"]
            dev["window_s"] = reduced["window_s"]
            breakdown = {"device_ops": reduced["device_ops"],
                         "idle_gaps": reduced["idle_gaps"]}
        return Run(checks.correct, sites, checks.failed_rows, metrics, dev,
                   {k: {"value": v, "limit": lim}
                    for k, (v, lim) in checks.numbers.items()},
                   breakdown, record)
    finally:
        if rows is not None:
            with contextlib.suppress(RuntimeError):
                rows.close()
        if entry is not None:
            entry.close()
        shutil.rmtree(work, ignore_errors=True)
