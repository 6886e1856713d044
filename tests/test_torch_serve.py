"""The port's serve (deepsignal_plant_tpu_torch) on the CPU: the
counterparts of tests/test_serve.py, on the port's engine with
``--device cpu``, with the calls held against the JAX engine's on the
same checkpoint (columns 1-6 and 10 identical, probabilities within 2e-6
at float32 wire and compute, as tests/test_torch_call_mods.py gates).

The port's engine calls features TSVs, .npz feature batches and fast5
run-folders (through the fused fast5 path; served bytes equal the
call_mods CLI's on the same directory).
"""
import gzip
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from deepsignal_plant_tpu.config import CallConfig as JaxCallConfig
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.models.bilstm import init_params
from deepsignal_plant_tpu.models.convert import save_checkpoint
from deepsignal_plant_tpu.parallel.mesh import make_mesh
from deepsignal_plant_tpu.pipeline.call_mods import \
    CallModsEngine as JaxEngine
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import CallConfig, ModelConfig
from deepsignal_plant_tpu_torch.pipeline.call_mods import CallModsEngine
from deepsignal_plant_tpu_torch.pipeline.serve import WatchServer
from make_synthetic import synth_feature_rows, write_feature_file
from test_torch_call_mods import assert_rows_agree, read_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "m.ckpt.npz")
    cfg = JaxModelConfig(hidden_size=32, dropout_rate=0.0)
    save_checkpoint(path, init_params(jax.random.PRNGKey(0), cfg), cfg)
    return path


def _make_engine(ckpt, transfer_dtype="float16"):
    cfg = ModelConfig(hidden_size=32, dropout_rate=0.0,
                      compute_dtype="float32")
    return CallModsEngine(ckpt, cfg, CallConfig(
        device_batch=256, transfer_dtype=transfer_dtype), "cpu")


def _jax_rows(ckpt, feat_path, out_path):
    cfg = JaxModelConfig(hidden_size=32, dropout_rate=0.0,
                         recurrence="scan", compute_dtype="float32")
    eng = JaxEngine(ckpt, cfg, JaxCallConfig(transfer_dtype="float32"),
                    mesh=make_mesh(jax.devices()[:1]))
    eng.run_features_file(feat_path, out_path, use_fast_path=False)
    return read_rows(out_path)


def test_watch_server_backlog_and_markers(tmp_path, rng, ckpt):
    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    write_feature_file(str(watch / "a.tsv"),
                       synth_feature_rows(rng, 4, 16))
    write_feature_file(str(watch / "b.tsv"),
                       synth_feature_rows(rng, 3, 16))
    (watch / "ignored.txt").write_text("not features\n")
    (watch / ".hidden.tsv").write_text("skip\n")

    server = WatchServer(_make_engine(ckpt, "float32"), str(watch),
                         str(out), poll_s=0.01)
    server.run(once=True)

    for name, rows in (("a.tsv", 4 * 16), ("b.tsv", 3 * 16)):
        res = out / f"{name}.call_mods.tsv"
        assert res.exists()
        got = read_rows(str(res))
        assert len(got) == rows
        marker = (out / f"{name}.done").read_text().split("\t")
        assert int(marker[0]) == rows
        want = _jax_rows(ckpt, str(watch / name),
                         str(tmp_path / f"jax.{name}"))
        assert_rows_agree(got, want)
    assert not (out / "ignored.txt.call_mods.tsv").exists()

    # at-most-once: a second backlog run reprocesses nothing
    before = {p.name: p.stat().st_mtime_ns for p in out.iterdir()}
    server2 = WatchServer(_make_engine(ckpt), str(watch), str(out),
                          poll_s=0.01)
    server2.run(once=True)
    after = {p.name: p.stat().st_mtime_ns for p in out.iterdir()}
    assert before == after


def test_watch_server_failed_marker_keeps_serving(tmp_path, rng, ckpt):
    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    (watch / "bad.tsv").write_text("this\tis\tnot\ta\tfeature\trow\n")
    write_feature_file(str(watch / "good.tsv"),
                       synth_feature_rows(rng, 2, 8))

    server = WatchServer(_make_engine(ckpt), str(watch), str(out),
                         poll_s=0.01)
    server.run(once=True)

    assert (out / "bad.tsv.failed").exists()
    assert "malformed features row" in (out / "bad.tsv.failed").read_text()
    assert not (out / "bad.tsv.call_mods.tsv").exists()
    assert (out / "good.tsv.done").exists()
    assert sum(1 for _ in open(out / "good.tsv.call_mods.tsv")) == 16
    # no temp left behind by the failed call
    assert not [p for p in out.iterdir() if p.name.startswith(".")]


def test_watch_server_waits_for_stable_files(tmp_path, rng, ckpt):
    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    write_feature_file(str(watch / "x.tsv"), synth_feature_rows(rng, 2, 8))

    server = WatchServer(_make_engine(ckpt), str(watch), str(out),
                         poll_s=0.01)
    # first sweep only records the signature — nothing processed yet
    assert server.sweep() == 0
    # file grows between polls: still not stable
    with open(watch / "x.tsv", "a") as fh:
        fh.write("\n".join(synth_feature_rows(rng, 1, 8)) + "\n")
    assert server.sweep() == 0
    # unchanged across two polls: processed now
    assert server.sweep() == 1
    assert (out / "x.tsv.done").exists()
    assert sum(1 for _ in open(out / "x.tsv.call_mods.tsv")) == 3 * 8


def test_watch_server_complete_marker(tmp_path, rng, ckpt):
    """X.complete makes X ready on the FIRST sweep (no stability wait);
    require_complete makes the marker the only pickup signal."""
    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    write_feature_file(str(watch / "m.tsv"), synth_feature_rows(rng, 2, 8))
    (watch / "m.tsv.complete").touch()
    write_feature_file(str(watch / "u.tsv"), synth_feature_rows(rng, 1, 8))

    server = WatchServer(_make_engine(ckpt), str(watch), str(out),
                         poll_s=0.01)
    assert server.sweep() == 1
    assert (out / "m.tsv.done").exists()
    assert not (out / "u.tsv.done").exists()
    assert server.sweep() == 1
    assert (out / "u.tsv.done").exists()

    watch2 = tmp_path / "in2"
    out2 = tmp_path / "out2"
    watch2.mkdir()
    write_feature_file(str(watch2 / "m.tsv"), synth_feature_rows(rng, 2, 8))
    (watch2 / "m.tsv.complete").touch()
    write_feature_file(str(watch2 / "u.tsv"), synth_feature_rows(rng, 1, 8))
    strict = WatchServer(_make_engine(ckpt), str(watch2), str(out2),
                         poll_s=0.01, require_complete=True)
    for _ in range(3):
        strict.sweep()
    assert (out2 / "m.tsv.done").exists()
    assert not (out2 / "u.tsv.done").exists()
    (watch2 / "u.tsv.complete").touch()
    assert strict.sweep() == 1
    assert (out2 / "u.tsv.done").exists()


def test_serve_cli_once(tmp_path, rng, ckpt):
    """End to end through the port's CLI with --once --device cpu, in a
    fresh interpreter."""
    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    write_feature_file(str(watch / "f.tsv"), synth_feature_rows(rng, 3, 8))

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "deepsignal_plant_tpu_torch", "serve",
         "--watch_dir", str(watch), "--result_dir", str(out),
         "--model_path", ckpt, "--hid_rnn", "32", "--once",
         "--device_batch", "256", "--device", "cpu", "--verbose_stages"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-1500:]
    assert "compute float32" in r.stdout, r.stdout[-500:]
    assert "calls .tsv, .npz, .tsv.gz and fast5 run-folders" in r.stdout
    stages = [ln for ln in r.stdout.splitlines()
              if ln.startswith("[stages] ")]
    assert len(stages) == 1 and '"sites": 24' in stages[0]
    assert (out / "f.tsv.done").exists()
    assert sum(1 for _ in open(out / "f.tsv.call_mods.tsv")) == 24


def test_watch_server_run_folder_not_picked(tmp_path, rng, ckpt):
    """A WatchServer built without extraction flags (``extract_args``)
    does not pick up a subdirectory of fast5s (a sequencer run-folder),
    as in the JAX server; nor does it pick up a plain directory."""
    from make_synthetic import synth_fast5_dir, synth_genome

    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    genome = synth_genome(rng, {"chr1": 4000})
    synth_fast5_dir(str(watch / "run_0001"), genome, rng, n_reads=4,
                    read_len=300)
    (watch / "not_a_run").mkdir()
    (watch / "not_a_run" / "x.txt").write_text("hi")

    server = WatchServer(_make_engine(ckpt), str(watch), str(out),
                         poll_s=0.01)
    server.run(once=True)
    assert sorted(p.name for p in out.iterdir()) == []


def test_watch_server_gz_and_npz_inputs(tmp_path, rng, ckpt):
    """.tsv.gz and .npz inputs (a v1 container of the same rows) call
    identically to the same rows as plain TSV; an .npz that is not a
    feature container gets a .failed marker and the server goes on."""
    from deepsignal_plant_tpu_torch.utils.fastparse import \
        parse_feature_bytes
    from deepsignal_plant_tpu_torch.utils.formats import save_feature_npz
    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    rows = synth_feature_rows(rng, 3, 8)
    write_feature_file(str(watch / "a.tsv"), rows)
    with gzip.open(watch / "b.tsv.gz", "wt") as fh:
        fh.write("\n".join(rows) + "\n")
    save_feature_npz(str(watch / "c.npz"), parse_feature_bytes(
        ("\n".join(rows) + "\n").encode()))
    np.savez(watch / "d.npz", kmer=np.zeros((24, 13), np.int32))

    server = WatchServer(_make_engine(ckpt), str(watch), str(out),
                         poll_s=0.01)
    server.run(once=True)

    ref = (out / "a.tsv.call_mods.tsv").read_bytes()
    assert len(ref.splitlines()) == 24
    assert (out / "b.tsv.gz.done").exists()
    assert (out / "b.tsv.gz.call_mods.tsv").read_bytes() == ref
    assert (out / "c.npz.done").exists()
    assert (out / "c.npz.call_mods.tsv").read_bytes() == ref
    assert "inference container" in (out / "d.npz.failed").read_text()
    assert not (out / "d.npz.call_mods.tsv").exists()


def test_watch_server_gzip_mode(tmp_path, rng, ckpt):
    """In gzip mode the engine's writer forces a .gz suffix; the temp
    name keeps it, so the rename finds the output."""
    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    write_feature_file(str(watch / "a.tsv"),
                       synth_feature_rows(rng, 2, 8))

    server = WatchServer(_make_engine(ckpt), str(watch), str(out),
                         poll_s=0.01, is_gzip=True)
    server.run(once=True)

    assert (out / "a.tsv.done").exists(), \
        (out / "a.tsv.failed").read_text() \
        if (out / "a.tsv.failed").exists() else "no marker at all"
    res = out / "a.tsv.call_mods.tsv.gz"
    assert res.exists()
    with gzip.open(res, "rt") as fh:
        assert sum(1 for _ in fh) == 16
    assert not [p for p in out.iterdir() if p.name.startswith(".")]


def test_watch_server_same_dir_no_self_ingestion(tmp_path, rng, ckpt):
    """result_dir == watch_dir must not re-call our own outputs
    (X.call_mods.tsv matches the input extensions)."""
    d = tmp_path / "both"
    d.mkdir()
    write_feature_file(str(d / "a.tsv"), synth_feature_rows(rng, 2, 8))

    server = WatchServer(_make_engine(ckpt), str(d), str(d), poll_s=0.01)
    server.run(once=True)
    assert (d / "a.tsv.done").exists()
    for _ in range(3):
        assert server.sweep() == 0
    names = sorted(p.name for p in d.iterdir())
    assert "a.tsv.call_mods.tsv.call_mods.tsv" not in names
    assert not any(".done.call_mods" in n or ".failed.call_mods" in n
                   for n in names)


def test_npz_and_run_folders_stay_unmarked_across_restarts(
        tmp_path, rng, ckpt, capsys):
    """Through the CLI in this process: the startup line names what the
    server calls; two servers in turn call the TSV, the run-folder and
    the .npz batch (a v3 container) once each: every input carries one
    marker, and the restarted server calls nothing again."""
    from make_synthetic import synth_fast5_dir, synth_genome
    from deepsignal_plant_tpu_torch.utils.fastparse import (
        pack_raw_block, parse_raw_feature_block)
    from deepsignal_plant_tpu_torch.utils.formats import save_packed_npz

    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    write_feature_file(str(watch / "a.tsv"), synth_feature_rows(rng, 2, 8))
    b_tsv = write_feature_file(str(tmp_path / "b.tsv"),
                               synth_feature_rows(rng, 2, 8))
    with open(b_tsv, "rb") as fh:
        save_packed_npz(str(watch / "b.npz"),
                        pack_raw_block(parse_raw_feature_block(fh.read())))
    (watch / "b.npz.complete").touch()
    synth_fast5_dir(str(watch / "run_0001"), synth_genome(
        rng, {"chr1": 3000}), rng, n_reads=2, read_len=300)
    argv = ["serve", "-i", str(watch), "-o", str(out), "-m", ckpt,
            "--hid_rnn", "32", "--once", "--poll_s", "0.01", "--device",
            "cpu", "--verbose_stages"]
    handlers = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    for _ in range(2):
        cli.main(argv)
    # the server put back the handlers it replaced
    assert [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)] \
        == handlers
    text = capsys.readouterr().out
    assert "calls .tsv, .npz, .tsv.gz and fast5 run-folders" in text
    assert text.count("[serve] a.tsv: 16 sites") == 1
    assert text.count("[serve] b.npz: 16 sites") == 1
    assert text.count("[serve] run_0001: ") == 1
    assert sorted(p.name for p in out.iterdir()) == \
        ["a.tsv.call_mods.tsv", "a.tsv.done", "b.npz.call_mods.tsv",
         "b.npz.done", "run_0001.call_mods.tsv", "run_0001.done"]


@pytest.mark.parametrize("flag", [
    ["--transfer_dtype", "int8"], ["--motifs", "CHG"],
    ["--corrected_group", "RawGenomeCorrected_001"], ["--nproc", "8"],
    ["--reference_path", "ref.fa"]])
def test_serve_refuses_unported_flags(tmp_path, ckpt, flag):
    """None of these is refused any more: the int8 wire is ported, and
    the fast5 run-folder flags are live since fast5 extraction was
    ported, so a server with any of them starts and serves the (empty)
    directory."""
    (tmp_path / "in").mkdir()
    argv = ["serve", "-i", str(tmp_path / "in"), "-o",
            str(tmp_path / "out"), "-m", ckpt, "--hid_rnn", "32",
            "--once", "--poll_s", "0.01", "--device", "cpu", *flag]
    assert cli.main(argv) == 0
    assert os.listdir(tmp_path / "out") == []


@pytest.mark.parametrize("transfer", ["float16", "float32"])
def test_run_folder_served_bytes_equal_cli(tmp_path, rng, ckpt, transfer):
    """A fast5 run-folder is served through the fused path, gets its
    .done marker with the site count, and its bytes equal the call_mods
    CLI's on the same directory with the same flags."""
    from make_synthetic import synth_fast5_dir, synth_genome

    watch = tmp_path / "in"
    out = tmp_path / "out"
    watch.mkdir()
    synth_fast5_dir(str(watch / "run_7"), synth_genome(
        rng, {"chr1": 3000, "chr2": 2000}), rng, n_reads=6, read_len=400,
        max_event_len=25)
    (watch / "run_7" / "nested").mkdir()
    os.replace(watch / "run_7" / "synthread_005.fast5",
               watch / "run_7" / "nested" / "synthread_005.fast5")
    flags = ["--hid_rnn", "32", "--device", "cpu", "--compute_dtype",
             "float32", "--transfer_dtype", transfer, "--nproc", "2",
             "--f5_batch_size", "2", "--motifs", "CHG"]
    cli.main(["serve", "-i", str(watch), "-o", str(out), "-m", ckpt,
              "--once", "--poll_s", "0.01", *flags])
    served = (out / "run_7.call_mods.tsv").read_bytes()
    cli.main(["call_mods", "-i", str(watch / "run_7"), "-m", ckpt, "-o",
              str(tmp_path / "cli.tsv"), *flags])
    assert served == (tmp_path / "cli.tsv").read_bytes()
    n = len(served.splitlines())
    assert n > 50
    assert (out / "run_7.done").read_text().split("\t")[0] == str(n)
