"""The port's inference pipelines at 4 ranks on the CPU (gloo; started by
tests/torch_launch.py as torchrun would): the counterparts of
tests/test_dist_4proc.py (b) and (c), each held against the JAX package
run as a 4-process jax.distributed pod (CPU, gloo collectives) on the
same inputs, and against the port's own one-process run.

- call_mods straight on a fast5 directory and extract from it: each rank
  takes its round-robin share of the sorted fast5 list and writes
  ``<root>.host<RANK><ext>``; the sorted union of the four outputs is
  byte for byte the sorted output of one process, and rank r's file
  holds JAX host r's rows (extract: the same bytes, the .npz
  directories the same arrays; call_mods at float32: columns 1-6 and 10
  identical, both probabilities within 2e-6).
- pod call_freq: a shared input list (sharded, merged on rank 0), the
  same with --device_agg on the CPU, per-rank disjoint lists (kept,
  merged), and a partial overlap (refused on every rank, as by every
  JAX host); rank 0's output is byte-equal to JAX host 0's and to one
  process's call_freq over every input, and no other rank writes it.
  With --contigs the ranks share out the contigs and each writes its
  own ``.host<RANK>`` file, JAX host r's bytes; together they hold one
  process's rows.
"""
import json
import os
import sys

import numpy as np
import pytest

from make_synthetic import synth_fast5_dir, synth_genome, write_fasta
from test_torch_call_mods import assert_rows_agree, read_rows
from test_torch_npz import _assert_same_files
from torch_launch import cli, launch

from deepsignal_plant_tpu_torch import cli as port_cli
from deepsignal_plant_tpu_torch.config import ModelConfig
from deepsignal_plant_tpu_torch.models.bilstm import init_params
from deepsignal_plant_tpu_torch.models.convert import save_checkpoint
from deepsignal_plant_tpu_torch.utils import formats as pfm

WORLD = 4
NARROW_FLAGS = ["--hid_rnn", "32", "--layernum1", "2"]
F32 = ["--compute_dtype", "float32", "--transfer_dtype", "float32"]

# one JAX host of a jax.distributed pod (CPU, one device a process): the
# JAX CLI's commands in turn, ``{rank}`` already filled in by the launcher
_JAX_HOST = r'''
import json, os, sys
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
os.environ.update(JAX_PLATFORMS="cpu", JAX_NUM_PROCESSES=str(world),
                  JAX_PROCESS_ID=str(rank), JAX_COORDINATOR_ADDRESS=
                  "127.0.0.1:" + os.environ["MASTER_PORT"])
import jax
jax.config.update("jax_cpu_collectives_implementation", "gloo")
from deepsignal_plant_tpu import cli
from deepsignal_plant_tpu.parallel.dist import init_distributed
init_distributed()
assert jax.process_count() == world
for name, argv in json.loads(sys.argv[1]):
    args = cli.build_parser().parse_args(argv)
    try:
        args.func(args)
        print("JOB %s ok" % name, flush=True)
    except ValueError as e:
        print("JOB %s raised: %s" % (name, e), flush=True)
'''


def run_ranks(*args) -> list:
    return launch(cli(*args), WORLD)


def check_ok(outs):
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r}:\n{out[-4000:]}"


def sorted_lines(*paths) -> list:
    lines = []
    for p in paths:
        with open(p, "rb") as fh:
            lines += fh.read().splitlines()
    return sorted(lines)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod")
    rng = np.random.default_rng(41)
    genome = synth_genome(rng, {"chr1": 5000, "chr2": 4000})
    ref = write_fasta(str(tmp / "ref.fa"), genome)
    synth_fast5_dir(str(tmp / "f5"), genome, rng, n_reads=10, read_len=500,
                    max_event_len=25, meth_mode="mixed")
    cfg = ModelConfig(hidden_size=32, num_layers_comb=2)
    ckpt = str(tmp / "narrow.ckpt.npz")
    save_checkpoint(ckpt, init_params(cfg, 7), cfg)
    return {"tmp": tmp, "dir": str(tmp / "f5"), "ref": ref, "ckpt": ckpt}


def npz_dir(path) -> dict:
    return {f: pfm._read_npz_arrays(os.path.join(path, f))
            for f in sorted(os.listdir(path))}


def test_fused_call_mods_and_extract_share_the_fast5s(run, jax_pod,
                                                      tmp_path):
    common = ["--reference_path", run["ref"], "--nproc", "1",
              "--f5_batch_size", "2"]
    call = ["-i", run["dir"], "-m", run["ckpt"], "--device", "cpu",
            *NARROW_FLAGS, *common]
    check_ok(run_ranks("call_mods", *call, "-o", str(tmp_path / "c.tsv")))
    port_cli.main(["call_mods", *call, "-o", str(tmp_path / "one.tsv")])
    hosts = [str(tmp_path / f"c.host{r}.tsv") for r in range(WORLD)]
    assert not os.path.exists(tmp_path / "c.tsv")
    assert all(os.path.getsize(h) for h in hosts)
    one = sorted_lines(tmp_path / "one.tsv")
    assert len(one) > 200 and sorted_lines(*hosts) == one
    # at float32, rank r calls JAX host r's reads to JAX's rows
    check_ok(run_ranks("call_mods", *call, *F32, "-o",
                       str(tmp_path / "c32.tsv")))
    assert jax_job(jax_pod, "call_mods") == ["JOB call_mods ok"] * WORLD
    for r in range(WORLD):
        got = sorted(read_rows(str(tmp_path / f"c32.host{r}.tsv")))
        want = sorted(read_rows(os.path.join(jax_pod["dir"],
                                             f"c.host{r}.tsv")))
        assert got
        assert_rows_agree(got, want)

    ext = ["-i", run["dir"], *common]
    check_ok(run_ranks("extract", *ext, "-o", str(tmp_path / "f.tsv")))
    port_cli.main(["extract", *ext, "-o", str(tmp_path / "f1.tsv")])
    hosts = [str(tmp_path / f"f.host{r}.tsv") for r in range(WORLD)]
    assert sorted_lines(*hosts) == sorted_lines(tmp_path / "f1.tsv")
    for r in range(WORLD):
        with open(hosts[r], "rb") as a, open(os.path.join(
                jax_pod["dir"], f"f.host{r}.tsv"), "rb") as b:
            assert a.read() == b.read()
    # the .npz outputs are directories, suffixed the same way
    check_ok(run_ranks("extract", *ext, "-o", str(tmp_path / "npz"),
                       "--w_format", "npz"))
    for r in range(WORLD):
        _assert_same_files(npz_dir(tmp_path / f"npz.host{r}"), npz_dir(
            os.path.join(jax_pod["dir"], f"npz.host{r}")))
    assert not os.path.exists(tmp_path / "npz")
    assert not os.path.exists(os.path.join(jax_pod["dir"], "npz"))


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """Four call_mods outputs whose sites overlap (coverage spans
    files, so the merge must sum), in a directory of their own."""
    d = tmp_path_factory.mktemp("calls")
    shared = d / "shared"
    shared.mkdir()
    for i in range(WORLD):
        with open(shared / f"calls_{i}.tsv", "w") as f:
            for j in range(300):
                pos = (j + i * 150) % 700
                p1 = round((j * 37 % 100) / 100, 6)
                p0 = round(1 - p1, 6)
                f.write(f"chr{j % 3}\t{pos}\t+\t{pos}\tr{i}_{j}\tt\t{p0}\t"
                        f"{p1}\t{int(p1 > 0.5)}\tACGTACCGTACGT\n")
    return {"dir": str(shared),
            "files": [str(shared / f"calls_{i}.tsv") for i in range(WORLD)]}


def freq_jobs(calls: dict, out: str) -> list:
    """The pod call_freq commands of the tests below, by name."""
    shared = ["-i", calls["dir"], "--sort", "--prob_cf", "0.1"]
    return [
        ["shared", ["call_freq", *shared, "-o", f"{out}/shared.tsv"]],
        ["shared_device_agg", ["call_freq", *shared, "--device_agg", "-o",
                               f"{out}/shared_device_agg.tsv"]],
        ["disjoint", ["call_freq", "-i", os.path.join(
            calls["dir"], "calls_{rank}.tsv"), "--sort", "--prob_cf", "0.1",
            "-o", f"{out}/disjoint.tsv"]],
        ["overlap", ["call_freq", "-i", calls["files"][0], "-i",
                     os.path.join(calls["dir"], "calls_{rank}.tsv"), "-o",
                     f"{out}/overlap.tsv"]],
        ["contigs", ["call_freq", "-i", calls["dir"], "--contigs",
                     "chr0,chr1,chr2", "--sort", "-o", f"{out}/contigs.tsv"]]]


@pytest.fixture(scope="module")
def jax_pod(run, calls, tmp_path_factory):
    """The JAX package's outputs of every command here as a 4-host
    jax.distributed pod, in one launch: {"dir": outputs, "outs": each
    host's log}."""
    out = str(tmp_path_factory.mktemp("jax_pod"))
    common = ["--reference_path", run["ref"], "--nproc", "1",
              "--f5_batch_size", "2"]
    jobs = [
        ["call_mods", ["call_mods", "-i", run["dir"], "-m", run["ckpt"],
                       "-o", f"{out}/c.tsv", *NARROW_FLAGS, *F32,
                       "--recurrence", "scan", *common]],
        ["extract", ["extract", "-i", run["dir"], "-o", f"{out}/f.tsv",
                     *common]],
        ["extract_npz", ["extract", "-i", run["dir"], "-o", f"{out}/npz",
                         "--w_format", "npz", *common]],
        *freq_jobs(calls, out)]
    outs = launch([sys.executable, "-c", _JAX_HOST, json.dumps(jobs)], WORLD,
                  env={"XLA_FLAGS": "", "JAX_PLATFORMS": "cpu"})
    check_ok(outs)
    for r, (_, o) in enumerate(outs):
        done = [ln for ln in o.splitlines() if ln.startswith("JOB ")]
        assert len(done) == len(jobs), f"JAX host {r}:\n{o[-4000:]}"
    return {"dir": out, "outs": [o for _, o in outs]}


def jax_job(jax_pod, name: str) -> list:
    """Each JAX host's result line of one command."""
    return [[ln for ln in o.splitlines() if ln.startswith(f"JOB {name} ")][0]
            for o in jax_pod["outs"]]


@pytest.mark.parametrize("layout", ["shared", "shared_device_agg",
                                    "disjoint"])
def test_pod_call_freq_merges_on_rank0(calls, jax_pod, tmp_path, layout):
    argv = dict(freq_jobs(calls, str(tmp_path)))[layout]
    if layout == "shared_device_agg":
        argv = [*argv, "--device", "cpu"]
    outs = run_ranks(*argv)
    check_ok(outs)
    want = "shared input list" if layout.startswith("shared") else \
        "disjoint per-rank inputs"
    assert all(want in o for _, o in outs)
    assert jax_job(jax_pod, layout) == [f"JOB {layout} ok"] * WORLD
    out = str(tmp_path / f"{layout}.tsv")
    one = str(tmp_path / "one.tsv")
    port_cli.main(["call_freq", "-i", calls["dir"], "-o", one, "--sort",
                   "--prob_cf", "0.1"])
    with open(out, "rb") as a, open(one, "rb") as b, open(os.path.join(
            jax_pod["dir"], f"{layout}.tsv"), "rb") as j:
        got = a.read()
        assert got == b.read() and got == j.read()
    # every rank reports the global counts; only rank 0 wrote
    report = [ln for ln in outs[0][1].splitlines() if "calls used" in ln]
    assert report and all(report[0] in o for _, o in outs)
    assert sorted(os.listdir(tmp_path)) == sorted([f"{layout}.tsv",
                                                   "one.tsv"])


def test_pod_call_freq_refuses_a_partial_overlap(calls, jax_pod, tmp_path):
    """Rank r reads calls_0 and calls_r: the lists neither match nor are
    disjoint, so every rank refuses to guess the partition, as every JAX
    host does."""
    argv = dict(freq_jobs(calls, str(tmp_path)))["overlap"]
    outs = run_ranks(*argv)
    for rc, out in outs:
        assert rc != 0 and "neither match exactly" in out, out[-3000:]
    assert all("neither match exactly" in ln
               for ln in jax_job(jax_pod, "overlap"))
    assert not os.path.exists(tmp_path / "overlap.tsv")


def test_pod_call_freq_contigs_write_per_rank_files(calls, jax_pod,
                                                    tmp_path):
    argv = dict(freq_jobs(calls, str(tmp_path)))["contigs"]
    check_ok(run_ranks(*argv))
    hosts = [tmp_path / f"contigs.host{r}.tsv" for r in range(WORLD)]
    assert all(h.exists() for h in hosts)
    assert not os.path.exists(tmp_path / "contigs.tsv")
    # 3 contigs over 4 ranks: ranks 0-2 one each, rank 3 none
    assert [h.stat().st_size > 0 for h in hosts] == [True] * 3 + [False]
    for r, h in enumerate(hosts):
        with open(os.path.join(jax_pod["dir"], f"contigs.host{r}.tsv"),
                  "rb") as j:
            assert h.read_bytes() == j.read()
    one = str(tmp_path / "one.tsv")
    port_cli.main(["call_freq", "-i", calls["dir"], "-o", one, "--contigs",
                   "chr0,chr1,chr2", "--sort"])
    with open(one, "rb") as fh:
        want = fh.read()
    got = b"".join(h.read_bytes() for h in hosts)
    assert got == want
