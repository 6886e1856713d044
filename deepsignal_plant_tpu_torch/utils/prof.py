"""Device traces and named stage spans (counterpart of
deepsignal_plant_tpu/utils/prof.py:66-78, whose ``device_trace`` writes a
``jax.profiler`` trace).

- ``device_trace(dir, cuda)``: a ``torch.profiler`` run over the block
  (CPU activity, and the card's kernels and copies when ``cuda``),
  exported as one Chrome trace (``<dir>/<name>-<pid>.trace.json``; open
  it in Perfetto or chrome://tracing). Nothing needs TensorBoard.
- ``stage(name, stats, counter, tag)``: a named span around one stage of
  the engine. It shows in a ``device_trace`` as a ``record_function``
  span, on the card's clock beside its kernels, and on the card as an
  NVTX range for tools that read NVTX. With ``counter`` the span's
  seconds are added to that field of ``stats``, so a counter is its
  span's summed duration. With ``tag`` a child span of that name (an
  engine unit's ``unit <i>``, a parsed block's ``block <j>``) carries
  the id: ``record_function``'s ``args`` do not reach the Chrome trace.

call_mods' spans (pipeline/call_mods.py; the counters are CallStats
fields). On the main thread, under one root span a call
(``run_features_file`` or ``run_blocks``), none nested in another:

    span         counter              covers
    parse_wait   parse_wait_seconds   blocked on the next parsed or
                                      loaded block
    batch        batch_seconds        cutting and concatenating blocks
                                      into batches, int8 quantization,
                                      cutting units into card shares
    upload       upload_seconds       staging into the pinned ring, the
                                      ring-slot wait, the copy's submission
    forward      forward_seconds      launching the tiled forward
    readback     readback_seconds     starting the readback, waiting on
                                      the card
    emit         format_seconds       row emission, label count, queueing
                                      the rows
    drain        drain_seconds        the writer's drain at the call's end

In the loader and parser threads: ``parse`` (``parse_seconds``), tagged
with the block's index.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

_NVTX = torch.cuda.is_available()


@contextlib.contextmanager
def _span(name: str):
    """A torch.profiler span, and an NVTX range on the card."""
    with torch.profiler.record_function(name):
        if _NVTX:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if _NVTX:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def stage(name: str, stats=None, counter: str | None = None,
          tag: str | None = None):
    """A named span; its seconds added to ``stats.<counter>`` when a
    counter is named (timed inside the span, so that a traced run's span
    holds what its counter counts); a child span ``tag`` when one is
    given."""
    with _span(name):
        t = time.perf_counter()
        try:
            if tag is None:
                yield
            else:
                with _span(tag):
                    yield
        finally:
            if counter is not None:
                setattr(stats, counter, getattr(stats, counter)
                        + time.perf_counter() - t)


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
