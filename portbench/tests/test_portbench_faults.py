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
from portbench.lib import check, faults, spec

#: BENCHMARK.json's cells, and those held_back.json keeps out of it (their
#: host-bound rates spread too widely for a bound; PERF.md)
CELLS = ["f32.call_tsv_allc", "f32.call_npz_resident_allc",
         "bf16.call_npz_resident_allc", "bf16.call_fast5_allc"]
load = spec.load_cell
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
    assert any(run.checks[g]["value"] > run.checks[g]["limit"]
               for g in check.GAPS if g in run.checks)


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
