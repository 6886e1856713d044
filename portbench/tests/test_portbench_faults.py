"""The comparison fails what it must: a whole run of each cell on the
CPU at a small size (the chip's look skipped), with the timed path
broken underneath, comes out not correct; unbroken, correct. The
control (the plain reference in the workload's lower precision, in the
program's place) comes out not correct under the cell's limit too.

``test_control_on_the_card`` runs the control at the cell's own size on
the chip (``-m cuda``)."""
import contextlib
import time

import pytest
import torch

from portbench import harness
from portbench.lib import faults, spec

CELLS = ["f32.call_tsv_allc", "f32.call_npz_resident_allc",
         "bf16.call_npz_resident_allc"]
#: kept out of BENCHMARK.json (its host-bound rate spreads too widely for
#: a bound; PERF.md), its files kept for the cell a later change adds
TSV = {"name": "f32.call_tsv_allc", "config": "dp2_bilstm_b13s16_f32",
       "traffic": "allc_tsv_262k", "chips": 1}


def load(name):
    if name == TSV["name"]:
        return spec.cell_of(TSV, spec.read_json(spec.ROOT, "BENCHMARK.json"))
    return spec.load_cell(name)
SMALL = {"sites": 600, "reads_per_file": 1}
FAULTS = {"none": contextlib.nullcontext,
          "half_batch": faults.half_batch,
          "altered_answer": faults.altered_answer,
          "dropped_rows": faults.dropped_rows}


def _run(cell, seed, tmp_path, device=torch.device("cpu"), sizes=SMALL):
    return harness.run_cell(cell, seed, 0.01, False, device, time.time(),
                            sizes=sizes, workroot=str(tmp_path))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_path_is_not_correct(tmp_path, name, fault):
    cell = load(name)
    with FAULTS[fault]():
        run = _run(cell, 41, tmp_path)
    assert run.correct == (fault == "none"), run.checks
    assert (run.failed == 0) == (fault == "none")


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tmp_path, name):
    cell = load(name)
    with faults.control(cell.config, 43, torch.device("cpu"),
                        cell.workload["control"]):
        run = _run(cell, 43, tmp_path)
    assert not run.correct, run.checks
    assert run.checks["max_dp1"]["value"] > run.checks["max_dp1"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(tmp_path, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs there")
    cell = load(name)
    dev = torch.device("cuda", 0)
    for seed in (45, 46, 47):
        with faults.control(cell.config, seed, dev,
                            cell.workload["control"]):
            run = _run(cell, seed, tmp_path, dev, sizes=None)
        assert not run.correct, run.checks
