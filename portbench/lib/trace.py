"""The traced window's device timeline, from a ``torch.profiler`` run:
busy seconds (the union of every kernel, copy and set on the card),
seconds by kernel-name group (``kernels/*.json``), the operations that
took most time, and the idle time by what the host's main thread was
doing (the engine's stage spans, ``utils/prof.py::stage``, and the
benchmark's own).

The window is the benchmark's ``portbench.window`` span.

A cell with an end-to-end metric from the device trace runs every
window, untraced ones too, under ``device_profiler``: the card's
activity only, no host operations, so the host's work is not slowed by
recording; ``busy_seconds`` reads the union of that activity. That
profile spans the window and nothing else."""
from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

WINDOW = "portbench.window"
PASS = "portbench.pass"
OUTPUT_WAIT = "portbench.output_wait"
#: main-thread spans that say what the host was doing (the engine's,
#: utils/prof.py, and the benchmark's); parse spans run in the parser
#: threads and are not named here
STAGES = ("parse_wait", "batch", "upload", "forward", "readback", "emit",
          "drain", OUTPUT_WAIT)
IN_PASS = "in a pass, no stage span"
BETWEEN = "between passes"
TOP = 10


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])


def device_profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def _device_events(prof):
    """(start_ns, end_ns, name) of every kernel, copy and set on the
    card: the timeline's device events less the host spans' shadows."""
    from torch.autograd import DeviceType
    names_host = set(STAGES) | {WINDOW, PASS}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA
                and e.name() not in names_host
                and not e.is_user_annotation()):
            yield e.start_ns(), e.end_ns(), e.name()


def busy_seconds(prof) -> float:
    """Seconds in which a kernel, copy or set ran on the card, over the
    whole of a ``device_profiler`` profile."""
    iv = np.array([(a, b) for a, b, _ in _device_events(prof)],
                  np.int64).reshape(-1, 2)
    busy = _union(iv)
    return float((busy[:, 1] - busy[:, 0]).sum()) / 1e9 if len(busy) \
        else 0.0


def _union(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering (n, 2) intervals."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    last = np.concatenate([np.flatnonzero(new)[1:] - 1, [len(iv) - 1]])
    return np.stack([starts, ends[last]], axis=1)


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    """Total overlap of two sets of disjoint sorted intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        if hi > lo:
            total += hi - lo
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return float(total)


def _short(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list (names in
    an anonymous namespace begin with a parenthesis)."""
    name = name.removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:120]


def reduce(prof, groups: dict[str, list[str]]) -> dict:
    """The timeline's numbers, in seconds."""
    from torch.autograd import DeviceType
    names_host = set(STAGES) | {WINDOW, PASS}
    dev = list(_device_events(prof))
    host, window, main = defaultdict(list), None, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            continue
        if name == WINDOW:
            window = (e.start_ns(), e.end_ns())
            main = e.start_thread_id()
        elif name in names_host:
            host[name].append((e.start_ns(), e.end_ns(),
                               e.start_thread_id()))
    if window is None:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    w0, w1 = window
    spans = {k: np.array([(a, b) for a, b, t in v if t == main], np.int64
                         ).reshape(-1, 2) for k, v in host.items()}
    iv = np.array([(max(a, w0), min(b, w1)) for a, b, _ in dev
                   if b > w0 and a < w1], np.int64).reshape(-1, 2)
    busy = _union(iv)
    busy_ns = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    by_name: dict[str, float] = defaultdict(float)
    by_group = {g: 0.0 for g in groups}
    pats = {g: re.compile("|".join(p)) for g, p in groups.items()}
    for a, b, name in dev:
        if b > w0 and a < w1:
            d = min(b, w1) - max(a, w0)
            by_name[_short(name)] += d
            for g, pat in pats.items():
                if pat.search(name):
                    by_group[g] += d
    # idle time: the window less the busy union, split by the main
    # thread's innermost span
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle = {}
    for stage in STAGES:
        s = _union(spans.get(stage, np.zeros((0, 2), np.int64)))
        idle[stage] = _overlap(gaps, s)
    in_pass = _overlap(gaps, _union(spans.get(PASS, np.zeros((0, 2),
                                                              np.int64))))
    idle[IN_PASS] = in_pass - sum(idle[s] for s in STAGES
                                  if s != OUTPUT_WAIT)
    idle[BETWEEN] = float((gaps[:, 1] - gaps[:, 0]).sum()) - in_pass \
        - idle[OUTPUT_WAIT]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(((k, v) for k, v in idle.items() if v > 0),
                      key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "groups_s": {g: v / 1e9 for g, v in by_group.items()},
            "device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[k, v / 1e9] for k, v in gaps_top]}
