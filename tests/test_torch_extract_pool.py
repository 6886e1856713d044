"""The extraction pool of the port (pipeline/extract.py::_pool_results)
when a worker PROCESS dies: a batch that kills its worker every time is
quarantined (its files counted as failed, the other batches written in
order); a worker that dies once is replaced and nothing is lost. The
workers here wrap the real TSV worker and kill themselves on a marker
file name; they live in this module, which a spawned worker imports."""
import os
import signal

import numpy as np
import pytest

from deepsignal_plant_tpu_torch.pipeline import extract
from deepsignal_plant_tpu_torch.utils.fileio import get_fast5s
from make_synthetic import synth_fast5_dir, synth_genome


def crash_on_marker(paths, batch_idx=0):
    """Kill this worker for a batch holding a ``*crashme*`` file."""
    if any("crashme" in os.path.basename(p) for p in paths):
        os.kill(os.getpid(), signal.SIGKILL)
    return extract._worker_rows_part(paths, batch_idx)


def crash_once(paths, batch_idx=0):
    """Kill this worker the first time a ``*crashme*`` batch runs (a
    sentinel file beside the fast5s records it), then work normally."""
    if any("crashme" in os.path.basename(p) for p in paths):
        sentinel = os.path.join(os.path.dirname(paths[0]), ".crashed")
        try:
            os.close(os.open(sentinel, os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            pass
        else:
            os.kill(os.getpid(), signal.SIGKILL)
    return extract._worker_rows_part(paths, batch_idx)


@pytest.fixture
def run(tmp_path):
    rng = np.random.default_rng(17)
    genome = synth_genome(rng, {"chr1": 4000})
    d = tmp_path / "f5"
    synth_fast5_dir(str(d), genome, rng, n_reads=9, read_len=400,
                    max_event_len=25)
    os.replace(d / "synthread_004.fast5", d / "synthread_004_crashme.fast5")
    return d


def _extract(d, out, nproc):
    ctx = extract.ExtractContext.build(extract.ExtractOptions())
    return extract.extract_features(str(d), False, ctx, str(out),
                                    nproc=nproc, f5_batch_size=3)


def test_batch_that_kills_its_worker_is_quarantined(run, tmp_path,
                                                    monkeypatch, capsys):
    want_n, want_err = _extract(run, tmp_path / "one.tsv", 1)
    monkeypatch.setattr(extract, "_worker_rows_part", crash_on_marker)
    n, errors = _extract(run, tmp_path / "pool.tsv", 2)
    text = capsys.readouterr().out
    assert (want_n, want_err) == (9, 0)
    assert (n, errors) == (9, 3)
    # batches of 3 in get_fast5s' (directory listing) order
    files = get_fast5s(str(run), False)
    batches = [files[i:i + 3] for i in range(0, 9, 3)]
    bad = next(i for i, b in enumerate(batches)
               if any("crashme" in p for p in b))
    assert f"batch {bad} kills its worker — quarantined (3 files counted " \
        "as failed)" in text
    assert "3 of 9 fast5 files failed.." in text
    # the other two batches' reads, in the single-process run's order
    names = {os.path.basename(p)[:-len(".fast5")]
             for i, b in enumerate(batches) if i != bad for p in b}
    one = (tmp_path / "one.tsv").read_text().splitlines()
    got = (tmp_path / "pool.tsv").read_text().splitlines()
    assert got == [r for r in one if r.split("\t")[4] in names]
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith(".extract_parts_")]


def test_worker_that_dies_once_is_replaced(run, tmp_path, monkeypatch,
                                           capsys):
    _extract(run, tmp_path / "one.tsv", 1)
    monkeypatch.setattr(extract, "_worker_rows_part", crash_once)
    n, errors = _extract(run, tmp_path / "pool.tsv", 2)
    text = capsys.readouterr().out
    assert (run / ".crashed").exists()
    assert (n, errors) == (9, 0)
    assert ("a worker process died; respawning" in text
            or "isolating" in text)
    assert (tmp_path / "pool.tsv").read_bytes() == \
        (tmp_path / "one.tsv").read_bytes()
