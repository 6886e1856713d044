"""What a run may load, and BENCHMARK.json against the contract's shape.

The check of loaded modules compares top-level names whole: the
program's ``deepsignal_plant_tpu_torch`` begins with the JAX package's
name and is not it."""
import json
import os
import re
import subprocess
import sys

import pytest

from portbench.lib import spec

BANNED = {"jax", "jaxlib", "flax", "deepsignal_plant_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _loaded_after(code: str) -> set:
    """Top-level names in sys.modules after ``code`` runs in a fresh
    interpreter from the checkout's root."""
    probe = (f"import sys; sys.path.insert(0, {spec.ROOT!r})\n{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run of a cell on the CPU at a small size: every module
    that run.py, the harness, the traffic kinds, the entries, the
    metrics and the reference import."""
    code = f"""
import time, torch
from portbench import harness
from portbench.lib import spec
for cell in (spec.load_cell("f32.call_tsv_allc"),
             spec.load_cell("bf16.call_npz_resident_allc"),
             spec.load_cell("bf16.call_fast5_allc")):
    run = harness.run_cell(cell, 3, 0.01, False, torch.device("cpu"),
                           time.time(), sizes={{"sites": 300,
                                                "reads_per_file": 1}},
                           workroot={str(tmp_path)!r})
    assert run.correct, run.checks
import portbench.run
for kind in ("metrics", "entries", "traffic"):
    import os
    for f in os.listdir(os.path.join(spec.BENCH_DIR, kind)):
        if f.endswith(".py"):
            spec.load_module(kind, f[:-3])
"""
    loaded = _loaded_after(code)
    assert "deepsignal_plant_tpu_torch" in loaded
    assert not loaded & BANNED, loaded & BANNED


def test_the_reference_imports_nothing_of_the_program():
    """Neither reference, nor a traffic kind with the writers it uses."""
    loaded = _loaded_after(
        "import os\n"
        "import portbench.reference.bilstm, portbench.reference.extract\n"
        "from portbench.lib import spec\n"
        "for f in os.listdir(os.path.join(spec.BENCH_DIR, 'traffic')):\n"
        "    if f.endswith('.py'):\n"
        "        spec.load_module('traffic', f[:-3])")
    assert "deepsignal_plant_tpu_torch" not in loaded
    assert "tests" not in loaded
    assert not loaded & BANNED


def test_benchmark_json_has_the_contracts_shape():
    bench = spec.read_json(spec.ROOT, "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        names.add(c["name"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec.load_cell(w["name"])            # every file it names is there
    cells = {w["name"] for w in bench["workloads"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    reports = {e["name"]: set(e.get("workloads", cells))
               for e in bench["end_to_end"]}
    for w in cells:     # setup_s and one more end-to-end metric a cell
        assert sum(w in on for on in reports.values()) >= 2, w
    for m in bench["per_layer"]:
        # every cell of the metric reports the metric that it moves
        assert set(m.get("workloads", cells)) <= reports[m["moves"]]
        assert set(m.get("workloads", cells)) <= cells
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))


def test_held_back_cells_are_whole_and_out_of_the_benchmark():
    bench = spec.read_json(spec.ROOT, "BENCHMARK.json")
    held = spec.read_json(spec.BENCH_DIR, "held_back.json")
    assert held["workloads"]
    assert not ({w["name"] for w in held["workloads"]}
                & {w["name"] for w in bench["workloads"]})
    for w in held["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = spec.load_cell(w["name"])     # every file it names is there
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer, w["name"]
    e2e = {m["name"] for m in held["end_to_end"]}
    assert all(m["moves"] in e2e for m in held["per_layer"])
    for m in held["end_to_end"] + held["per_layer"]:
        assert "bound" not in m
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("name", ["dp2_bilstm_b13s16_f32",
                                  "dp2_bilstm_b13s16_bf16"])
def test_configs_are_the_published_widths(name):
    cfg = spec.read_json(spec.BENCH_DIR, "configs", name + ".json")
    assert {k: cfg[k] for k in ("model_type", "seq_len", "signal_len",
                                "hid_rnn", "layernum1", "layernum2",
                                "class_num", "n_vocab", "n_embed",
                                "is_base", "is_signallen")} == {
        "model_type": "both_bilstm", "seq_len": 13, "signal_len": 16,
        "hid_rnn": 256, "layernum1": 3, "layernum2": 1, "class_num": 2,
        "n_vocab": 16, "n_embed": 4, "is_base": True, "is_signallen": True}
