"""The fast5 cell on the CPU at a small size: its traffic repeats from its
seed, the program reads every file it writes and extracts what the plain
extraction reference does, a traced run of the whole cell is correct and
names the engine's wait for extracted blocks, and broken input comes out
not correct."""
import dataclasses
import math
import os
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.lib import check, spec

CELL = "bf16.call_fast5_allc"
#: short reads, so that a few hundred sites span several files
SMALL = {"sites": 600, "read_len": [300, 700]}


def _traffic(**kw):
    cell = spec.load_cell(CELL)
    return {**cell.traffic, **SMALL, **kw}


def _make(tmp_path, sub, seed, **kw):
    p = _traffic(**kw)
    d = tmp_path / sub
    d.mkdir()
    kind = spec.load_module("traffic", p["kind"])
    return kind, kind.make(p, seed, str(d), p["sites"])


def _pooled(cell):
    """The cell with two extraction workers over batches of two files."""
    opts = {**cell.workload["options"], "nproc": 2, "f5_batch_size": 2}
    return dataclasses.replace(cell, workload={**cell.workload,
                                               "options": opts})


def _by_site(sample):
    return {info: (sample.kmer[k].tolist(), sample.means[k].tolist(),
                   sample.signals[k].tolist())
            for k, info in enumerate(sample.info)}


def test_fast5_traffic_repeats_from_its_seed(tmp_path):
    seed = 2**31 + 2**30 + 17        # past 32 signed bits
    kind, a = _make(tmp_path, "a", seed)
    _, b = _make(tmp_path, "b", seed)
    _, c = _make(tmp_path, "c", seed + 1)
    names = sorted(kind.listed(a.path))
    assert len(names) > 2 and names == sorted(kind.listed(b.path))
    for f in names:
        assert open(os.path.join(a.path, f), "rb").read() == open(
            os.path.join(b.path, f), "rb").read(), f
    assert a.sites == b.sites == c.sites == SMALL["sites"]
    assert _by_site(a.sample) == _by_site(b.sample)
    assert _by_site(a.sample) != _by_site(c.sample)


def test_the_program_extracts_what_the_reference_does(tmp_path):
    from deepsignal_plant_tpu_torch.io.fast5 import read_tombo_fast5
    from deepsignal_plant_tpu_torch.pipeline.extract import (
        ExtractContext, ExtractOptions, extract_read_features)
    kind, inp = _make(tmp_path, "f", 29)
    p = _traffic()
    ctx = ExtractContext.build(ExtractOptions(
        motifs=p["motif"], mod_loc=0, kmer_len=p["kmer_len"],
        signal_len=p["signal_len"], reference_path=os.path.join(
            os.path.dirname(inp.path), p["fasta"])))
    nb = p["kmer_len"] // 2
    info, kmer5, lens, means, stds, rect = [], [], [], [], [], []
    for f in kind.listed(inp.path):
        read = read_tombo_fast5(os.path.join(inp.path, f))
        assert read is not None, f
        ft = extract_read_features(read, ctx)
        win = ft["locs"][:, None] + np.arange(-nb, nb + 1)[None, :]
        info += [f"{ft['chrom']}\t{pos}\t{ft['strand']}\t{pis}\t"
                 f"{ft['readname']}\t{ft['read_strand']}".encode()
                 for pos, pis in zip(ft["pos"].tolist(),
                                     ft["pos_in_strand"].tolist())]
        kmer5 += [ft["seq"][c - 2:c + 3].encode()
                  for c in ft["locs"].tolist()]
        lens.append(ft["r_lens"][win])
        means.append(np.around(ft["r_means"][win], 6))
        stds.append(np.around(ft["r_stds"][win], 6))
        rect.append(ft["r_rect"][win])
    s = inp.sample                   # every site: check_sites >= sites
    assert info == s.info and kmer5 == s.kmer5
    np.testing.assert_array_equal(np.concatenate(lens), s.lens)
    for name, got, want in (("means", means, s.means),
                            ("stds", stds, s.stds),
                            ("rect", rect, s.signals)):
        np.testing.assert_allclose(np.concatenate(got), want, rtol=0,
                                   atol=1e-5, err_msg=name)


def test_the_reference_sites_are_every_c(tmp_path):
    kind, inp = _make(tmp_path, "s", 31)
    s = inp.sample
    assert (s.kmer[:, 6] == 1).all()                 # the centre is a C
    assert all(k[2:3] == b"C" for k in s.kmer5)
    # a window's bases carry 3-29 samples each
    assert s.lens.min() >= 3 and s.lens.max() <= 29
    # below 16 samples the rectangle holds them centred between zeros
    n = s.lens.astype(int)
    at = np.arange(16)
    left = (16 - n) // 2
    pad = (n[..., None] < 16) & ((at < left[..., None])
                                 | (at >= (left + n)[..., None]))
    assert pad.any() and (s.signals[pad] == 0).all()


def test_a_traced_run_is_correct_and_names_the_loader_wait(tmp_path):
    cell = _pooled(spec.load_cell(CELL))
    run = harness.run_cell(cell, 37, 0.01, True, torch.device("cpu"),
                           time.time(), sizes=SMALL,
                           workroot=str(tmp_path))
    assert run.correct, run.checks
    assert run.checks["fast5_failed"] == {"value": 0, "limit": 0}
    for name in ("parse_wait_share.call_mods", "wire_bytes_per_site",
                 "extract_cpu_s_per_msite"):
        assert run.metrics[name]["value"] > 0, name
    # a CPU run has no card: nothing of the device's is read
    assert "device_idle.call_mods" not in run.metrics
    gaps = dict(run.breakdown["idle_gaps"])
    assert gaps["parse_wait"] > 0
    assert "batching or parse wait (no stage span)" not in gaps


def test_an_untraced_run_reaps_the_workers_in_its_window(tmp_path):
    cell = _pooled(spec.load_cell(CELL))
    run = harness.run_cell(cell, 39, 0.01, False, torch.device("cpu"),
                           time.time(), sizes=SMALL,
                           workroot=str(tmp_path))
    assert run.correct, run.checks
    assert set(run.metrics) == {"setup_s", "sites_per_s",
                                "host_cpu_s_per_msite"}
    rec = run.record
    assert rec["children_cpu_s"] > 0
    host = run.metrics["host_cpu_s_per_msite"]["value"]
    extract = spec.load_module("metrics", "extract_cpu_s_per_msite").read(
        rec)
    assert host == pytest.approx(
        (rec["cpu_s"] + rec["children_cpu_s"]) / (rec["sites"] / 1e6))
    assert 0 < extract < host


def test_the_cell_is_held_back_from_the_benchmark():
    bench = spec.read_json(spec.ROOT, "BENCHMARK.json")
    assert CELL not in {w["name"] for w in bench["workloads"]}
    assert spec.load_cell(CELL).traffic["kind"] == "fast5_vbz"


@pytest.mark.parametrize("p1, p0, ref, gap", [
    (0.5, 0.5, 0.0, 0.0),
    (0.3, 0.7, math.log(3 / 7) + 0.2, 0.2),
    # 1e-5 printed: within its rounding the logit spans about 0.1
    (0.00001, 0.99999, math.log(1.04e-5 / 0.99999), 0.0),
    (0.00001, 0.99999, math.log(2e-5 / 0.99999), math.log(2 / 1.05)),
    # a printed 0 leaves the logit open below
    (0.0, 1.0, -40.0, 0.0),
    (0.0, 1.0, 0.0, -math.log(5e-7 / 0.9999995)),
])
def test_the_logit_gap_allows_for_the_prints_rounding(p1, p0, ref, gap):
    assert check.logit_gap(p1, p0, ref) == pytest.approx(gap, abs=1e-5)


@pytest.mark.parametrize("fault", ["fast5_emptied", "signal_altered"])
def test_broken_input_is_not_correct(tmp_path, fault):
    cell = spec.load_cell(CELL)
    kind = spec.load_module("traffic", cell.traffic["kind"])
    with kind.FAULTS[fault]():
        run = harness.run_cell(cell, 41, 0.01, False, torch.device("cpu"),
                               time.time(), sizes=SMALL,
                               workroot=str(tmp_path))
    assert not run.correct, run.checks
    c = {k: v["value"] for k, v in run.checks.items()}
    if fault == "fast5_emptied":
        assert c["fast5_failed"] == run.record["passes"]
        assert c["rows_missing"] > 0
    else:
        assert c["fast5_failed"] == 0 and c["rows_missing"] == 0
        assert c["max_dlogit"] > cell.workload["limits"]["max_dlogit"]
