"""Device traces and named stage ranges (counterpart of
deepsignal_plant_tpu/utils/prof.py:66-78, whose ``device_trace`` writes a
``jax.profiler`` trace).

- ``device_trace(dir, cuda)``: a ``torch.profiler`` run over the block
  (CPU activity, and the card's kernels and copies when ``cuda``),
  exported as one Chrome trace (``<dir>/<name>-<pid>.trace.json``; open
  it in Perfetto or chrome://tracing). Nothing needs TensorBoard.
- ``stage(name)``: a named range around one stage of the engine (parse,
  upload, forward, readback, emit). It shows in a ``device_trace`` as a
  ``record_function`` span, and on the card as an NVTX range for tools
  that read NVTX.

The engine's stage seconds stay in its ``[stages]`` JSON line
(pipeline/call_mods.py::CallStats); these ranges add the timeline.
"""
from __future__ import annotations

import contextlib
import os

import torch

_NVTX = torch.cuda.is_available()


@contextlib.contextmanager
def stage(name: str):
    """A named range: a torch.profiler span, and an NVTX range on the
    card."""
    with torch.profiler.record_function(name):
        if _NVTX:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if _NVTX:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def device_trace(trace_dir: str | None, cuda: bool, name: str = "call_mods"):
    """A torch.profiler trace of the block written to ``trace_dir``; a
    no-op when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, f"{name}-{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    print(f"[prof] device trace written to {path}")
