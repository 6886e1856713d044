"""call_mods' engine spans and counters in the port
(deepsignal_plant_tpu_torch/utils/prof.py, pipeline/call_mods.py), on
the CPU at a narrow width, one route a case: v3 .npz on the resident
plane, v3 .npz streaming, a features TSV at the float16 wire and at the
float32 wire.

- The seven main-thread stage counters cover the call, and
  ``unfed_seconds`` (no unit in flight) stays within the call and, where
  one unit makes the pass, holds every host stage outside the card's.
- In a ``--profile_dir`` trace each stage's main-thread spans add up to
  its counter, no two stage spans overlap, every unit's stages carry
  its ``unit <i>`` id under one root span a call, and the ``batch``
  spans' block ranges run through the call's blocks in order.
- The CLI's ``[stages]`` line holds the counters and the kernel launches
  from ``CallStats``; a traced benchmark run reads the new metrics.
"""
import gc
import glob
import json
import os
import re
import sys
import time

import numpy as np
import pytest
import torch

from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import CallConfig, ModelConfig
from deepsignal_plant_tpu_torch.models.bilstm import init_params
from deepsignal_plant_tpu_torch.models.convert import save_checkpoint
from deepsignal_plant_tpu_torch.ops import fused_lstm
from deepsignal_plant_tpu_torch.pipeline import call_mods
from deepsignal_plant_tpu_torch.utils.prof import device_trace
from make_synthetic import (synth_fast5_dir, synth_feature_rows,
                            synth_genome, write_feature_file)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(hidden_size=32, num_layers_comb=2)
NARROW_FLAGS = ["--hid_rnn", "32", "--layernum1", "2"]
#: stage span -> its CallStats counter
STAGES = {"parse_wait": "parse_wait_seconds", "batch": "batch_seconds",
          "upload": "upload_seconds", "forward": "forward_seconds",
          "readback": "readback_seconds", "emit": "format_seconds",
          "drain": "drain_seconds"}
UNIT_STAGES = {"batch", "upload", "forward", "readback", "emit"}
#: route -> (input, wire, --device_resident)
ROUTES = {"v3_resident": ("v3", "float16", "always"),
          "v3_streaming": ("v3", "float16", "never"),
          "tsv_float16": ("tsv", "float16", "never"),
          "tsv_float32": ("tsv", "float32", "never")}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A read-structured TSV (12 reads x 20 sites), v3 batches extracted
    from a fast5 run (3 reads a file), and a narrow checkpoint."""
    tmp = tmp_path_factory.mktemp("stages")
    rng = np.random.default_rng(29)
    out = {"tsv": write_feature_file(
        str(tmp / "f.tsv"), synth_feature_rows(rng, n_reads=12,
                                               sites_per_read=20))}
    genome = synth_genome(rng, {"chr1": 4000, "chr2": 3000})
    synth_fast5_dir(str(tmp / "f5"), genome, rng, n_reads=8, read_len=500,
                    max_event_len=25, meth_mode="mixed")
    cli.main(["extract", "-i", str(tmp / "f5"), "-o", str(tmp / "v3"),
              "--w_format", "npz_packed", "--nproc", "1",
              "--f5_batch_size", "3"])
    out["v3"] = str(tmp / "v3")
    cfg = ModelConfig(**NARROW)
    out["ckpt"] = str(tmp / "narrow.ckpt.npz")
    save_checkpoint(out["ckpt"], init_params(cfg, 3), cfg)
    return out


def _main_thread_spans(trace_path: str, root: str) -> list[dict]:
    """The complete events of the thread that ran the ``root`` span."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    tid = next(e["tid"] for e in events if e["name"] == root)
    return [e for e in events if e["tid"] == tid]


@pytest.fixture(scope="module", params=sorted(ROUTES))
def traced(request, inputs, tmp_path_factory):
    """One call of the route under a ``--profile_dir`` trace: its
    CallStats and its main thread's spans."""
    inp, wire, resident = ROUTES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    engine = call_mods.CallModsEngine(
        inputs["ckpt"], ModelConfig(compute_dtype="float32",
                                    dropout_rate=0.0, **NARROW),
        CallConfig(device_batch=64, transfer_dtype=wire,
                   device_resident=resident), "cpu")
    # a span's ends and its counter's clock reads are a few bytecodes
    # apart; a collection pause or the loader threads' turn with the
    # interpreter lock (5 ms by default) between them would take
    # milliseconds from the comparison of these millisecond spans
    gc.collect()
    gc.disable()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        with device_trace(str(tmp / "prof"), False):
            st = engine.run_features_file(inputs[inp], str(tmp / "o.tsv"))
    finally:
        sys.setswitchinterval(switch)
        gc.enable()
    trace, = glob.glob(str(tmp / "prof" / "call_mods-*.trace.json"))
    return (request.param, st,
            _main_thread_spans(trace, "run_features_file"))


def test_stage_counters_cover_the_call(traced):
    route, st, _ = traced
    covered = sum(getattr(st, c) for c in STAGES.values())
    assert st.sites > 150 and st.seconds > 0
    assert covered >= 0.9 * st.seconds, (covered, st.seconds)
    assert covered <= st.seconds
    assert 0 < st.unfed_seconds <= st.seconds
    if route == "v3_resident":      # one unit makes the whole pass
        assert st.units == st.resident_segments == 1
        host = (st.parse_wait_seconds + st.batch_seconds
                + st.format_seconds + st.drain_seconds)
        assert st.unfed_seconds >= host - 1e-3, (st.unfed_seconds, host)
    else:
        assert st.units == st.batches > 1
    assert not hasattr(st, "device_seconds")


def test_each_stage_span_adds_up_to_its_counter(traced):
    _, st, spans = traced
    for name, counter in STAGES.items():
        durs = [e["dur"] / 1e6 for e in spans if e["name"] == name]
        assert durs, name
        want = getattr(st, counter)
        assert abs(sum(durs) - want) <= max(0.05 * want, 2e-3), (
            name, sum(durs), want)


def test_stage_spans_never_overlap(traced):
    _, _, spans = traced
    root, = (e for e in spans if e["name"] == "run_features_file")
    stages = sorted((e for e in spans if e["name"] in STAGES),
                    key=lambda e: e["ts"])
    assert stages[0]["ts"] >= root["ts"]
    assert stages[-1]["ts"] + stages[-1]["dur"] <= \
        root["ts"] + root["dur"] + 1
    for a, b in zip(stages, stages[1:]):
        assert b["ts"] >= a["ts"] + a["dur"] - 1, (a, b)   # 1 us rounding


def _inside(child: dict, parent: dict) -> bool:
    return (parent["ts"] <= child["ts"] and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + 1)


def test_every_units_stages_carry_its_id(traced):
    _, st, spans = traced
    stages = [e for e in spans if e["name"] in UNIT_STAGES]
    tags = [e for e in spans if re.fullmatch(r"unit \d+", e["name"])]
    by_unit: dict[int, set] = {}
    for s in stages:
        ids = [t["name"] for t in tags if _inside(t, s)]
        assert len(ids) == 1, (s, ids)
        by_unit.setdefault(int(ids[0].split()[1]), set()).add(s["name"])
    assert sorted(by_unit) == list(range(st.units))
    assert all(names == UNIT_STAGES for names in by_unit.values())
    # the batch spans' block ranges run through the call's blocks
    ranges = [tuple(map(int, m.groups())) for m in (
        re.fullmatch(r"blocks (\d+)-(\d+)", e["name"]) for e in sorted(
            spans, key=lambda e: e["ts"])) if m]
    assert ranges[0][0] == 0 and ranges[-1][1] == st.blocks - 1
    assert all(a <= b for a, b in ranges)
    assert all(b0 >= a1 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))


def test_cli_stages_line_carries_the_counters(inputs, tmp_path, capsys):
    cli.main(["call_mods", "-i", inputs["v3"], "-m", inputs["ckpt"], "-o",
              str(tmp_path / "o.tsv"), "--device", "cpu", "--device_batch",
              "64", "--verbose_stages", *NARROW_FLAGS])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[stages] "))
    st = json.loads(line[len("[stages] "):])
    assert set(STAGES.values()) | {"unfed_seconds", "units", "blocks"} <= \
        set(st)
    assert "device_seconds" not in st
    assert set(st["kernel_launches"]) == set(fused_lstm.kernel_launches())
    assert not any(st["kernel_launches"].values())      # the plain kernels


def test_a_traced_benchmark_run_reads_the_new_metrics(tmp_path):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness
    from portbench.lib import spec
    cell = spec.load_cell("f32.call_npz_resident_allc")
    run = harness.run_cell(cell, 2 ** 31 + 77, 0.01, True,
                           torch.device("cpu"), time.time(),
                           sizes={"sites": 300, "reads_per_file": 1},
                           workroot=str(tmp_path))
    assert run.correct, run.checks
    for name in ("unfed_share.call_mods", "batch_share.call_mods"):
        value = run.metrics[name]["value"]
        assert value is not None and 0 < value < 100, (name, value)
