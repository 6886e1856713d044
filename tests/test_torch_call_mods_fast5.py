"""The port's call_mods on a fast5 directory (the fused path:
extraction workers feed the engine; pipeline/extract.py
extract_to_call_mods) on the CPU, against the JAX package's fused path
on the same directory and the same narrow checkpoint.

Gates (those of tests/test_torch_call_mods.py): sorted rows, columns 1-6
and 10 identical, both probabilities within 2e-6.
- float16 wire: against JAX's pooled fused path (read-packed float16
  parts, as the port's float16 plane ships);
- float32 wire: against JAX's in-process fused path (features_to_batch
  at float32, the port's float32 plane);
- the same bytes as the port's call_mods on the TSV its own extract
  wrote, and the same bytes at --nproc 1 and 2;
- the region and positions filters (as tests/test_engine_variants.py).
"""
import os

import jax
import numpy as np
import pytest

from deepsignal_plant_tpu import cli as jax_cli
from deepsignal_plant_tpu.config import CallConfig as JaxCallConfig
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.parallel.mesh import make_mesh
from deepsignal_plant_tpu.pipeline import extract as jax_extract
from deepsignal_plant_tpu.pipeline.call_mods import \
    CallModsEngine as JaxEngine
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.ops import fused_lstm
from make_synthetic import synth_fast5_dir, synth_genome, write_fasta
from test_torch_call_mods import (NARROW, NARROW_FLAGS, assert_rows_agree,
                                  ckpt, read_rows)  # noqa: F401

F32 = ["--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fused")
    rng = np.random.default_rng(31)
    genome = synth_genome(rng, {"chr1": 5000, "chr2": 4000})
    ref = write_fasta(str(tmp / "ref.fa"), genome)
    synth_fast5_dir(str(tmp / "f5"), genome, rng, n_reads=16, read_len=600,
                    max_event_len=25, meth_mode="mixed")
    pos = tmp / "positions.tsv"
    pos.write_text("".join(f"chr2\t{p}\t{s}\n" for p in range(0, 4000, 2)
                           for s in "+-"))
    return {"dir": str(tmp / "f5"), "ref": ref, "positions": str(pos)}


def port_rows(run, ckpt, out, *extra):
    cli.main(["call_mods", "-i", run["dir"], "-m", ckpt, "-o", str(out),
              "--device", "cpu", "--f5_batch_size", "5",
              "--reference_path", run["ref"], *NARROW_FLAGS, *F32, *extra])
    with open(out, "rb") as fh:
        return fh.read()


def jax_rows(run, ckpt, out, transfer, nproc, *extra):
    args = jax_cli.build_parser().parse_args(
        ["call_mods", "-i", run["dir"], "-m", ckpt, "-o", str(out),
         "--f5_batch_size", "5", "--nproc", str(nproc), "--reference_path",
         run["ref"], "--transfer_dtype", transfer, *extra])
    cfg = JaxModelConfig(recurrence="scan", compute_dtype="float32",
                         dropout_rate=0.0, **NARROW)
    eng = JaxEngine(ckpt, cfg, JaxCallConfig(transfer_dtype=transfer),
                    mesh=make_mesh(jax.devices()[:1]))
    jax_extract.extract_to_call_mods(eng, run["dir"], args, str(out))
    return sorted(read_rows(str(out)))


def _sorted(data: bytes):
    return sorted(ln.split("\t") for ln in data.decode().splitlines())


@pytest.mark.parametrize("transfer,jax_nproc", [("float16", 2),
                                               ("float32", 1)])
def test_fused_matches_jax(run, ckpt, tmp_path, transfer, jax_nproc):
    got = _sorted(port_rows(run, ckpt, tmp_path / "port.tsv",
                            "--transfer_dtype", transfer, "--nproc", "2"))
    want = jax_rows(run, ckpt, tmp_path / "jax.tsv", transfer, jax_nproc)
    assert len(got) > 500
    assert_rows_agree(got, want)


@pytest.mark.parametrize("transfer", ["float16", "float32"])
def test_fused_equals_tsv_plane_and_nproc(run, ckpt, tmp_path, transfer):
    """The fused path writes the bytes of call_mods on the port's own
    extracted TSV (sorted), and the same bytes at --nproc 1 and 2."""
    feats = str(tmp_path / "features.tsv")
    cli.main(["extract", "-i", run["dir"], "-o", feats, "--nproc", "1",
              "--reference_path", run["ref"]])
    cli.main(["call_mods", "-i", feats, "-m", ckpt, "-o",
              str(tmp_path / "tsv.out"), "--device", "cpu",
              "--transfer_dtype", transfer, *NARROW_FLAGS, *F32])
    tsv = open(tmp_path / "tsv.out", "rb").read()
    one = port_rows(run, ckpt, tmp_path / "p1.out", "--transfer_dtype",
                    transfer, "--nproc", "1")
    two = port_rows(run, ckpt, tmp_path / "p2.out", "--transfer_dtype",
                    transfer, "--nproc", "2", "--device_batch", "300")
    assert one == two
    assert sorted(one.splitlines()) == sorted(tsv.splitlines())


@pytest.mark.parametrize("flt", ["region", "positions"])
def test_fused_filters_match_jax(run, ckpt, tmp_path, flt):
    extra = (["--region", "chr1:1000-4000"] if flt == "region"
             else ["--positions", run["positions"]])
    got = _sorted(port_rows(run, ckpt, tmp_path / "port.tsv", "--nproc",
                            "1", *extra))
    want = jax_rows(run, ckpt, tmp_path / "jax.tsv", "float16", 2, *extra)
    assert 0 < len(got)
    assert_rows_agree(got, want)
    chroms = {r[0] for r in got}
    assert chroms == ({"chr1"} if flt == "region" else {"chr2"})
    if flt == "region":
        assert all(1000 <= int(r[1]) < 4000 for r in got)


def test_fused_counts_tiles_and_failed_files(run, ckpt, tmp_path, capsys):
    """--verbose_stages: the sites, the forward tiles, the fast5 files
    and their failures (a corrupt file is counted, not fatal); on the CPU
    no kernel launches."""
    import json
    import shutil
    d = tmp_path / "f5"
    shutil.copytree(run["dir"], d)
    (d / "zz_broken.fast5").write_bytes(b"garbage" * 10)
    before = dict(fused_lstm.launches)
    cli.main(["call_mods", "-i", str(d), "-m", ckpt, "-o",
              str(tmp_path / "o.tsv"), "--device", "cpu", "--nproc", "2",
              "--f5_batch_size", "6", "--device_batch", "400",
              "--verbose_stages", *NARROW_FLAGS, *F32])
    text = capsys.readouterr().out
    assert "1 of 17 fast5 files failed.." in text
    st = json.loads(next(ln for ln in text.splitlines()
                         if ln.startswith("[stages] "))[9:])
    assert st["fast5_files"] == 17 and st["fast5_errors"] == 1
    n = sum(1 for _ in open(tmp_path / "o.tsv"))
    assert st["sites"] == n and st["packed_sites"] == n
    assert st["forward_tiles"] == st["batches"] == -(-n // 400)
    assert dict(fused_lstm.launches) == before
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".fused")]


def test_npz_directory_still_refused(tmp_path, ckpt):
    """A directory of .npz batches is a feature input, not a fast5 run:
    call_mods reads it as one (here a container that is not a feature
    batch, which fails with the JAX loader's message)."""
    d = tmp_path / "npzdir"
    d.mkdir()
    np.savez(d / "000000.npz", x=np.zeros(3))
    with pytest.raises(ValueError, match="inference container"):
        cli.main(["call_mods", "-i", str(d), "-m", ckpt, "-o",
                  str(tmp_path / "o.tsv"), "--device", "cpu",
                  *NARROW_FLAGS])


def test_float32_nproc_fault_of_jax_is_not_ported(run, ckpt, tmp_path,
                                                  capsys):
    """JAX's fused path at --transfer_dtype float32 runs in-process at
    --nproc 1 (float32 per-site arrays) but ships float16 read-packed
    parts at --nproc > 1, so its float32 calls depend on --nproc. The
    port's float32 plane is the per-site float32 route at every --nproc:
    its bytes are equal, while JAX's two runs differ by at most one
    6-decimal step with no call flipped. The size is printed (-s)."""
    one = port_rows(run, ckpt, tmp_path / "p1.tsv", "--transfer_dtype",
                    "float32", "--nproc", "1")
    two = port_rows(run, ckpt, tmp_path / "p2.tsv", "--transfer_dtype",
                    "float32", "--nproc", "2")
    assert one == two
    a = jax_rows(run, ckpt, tmp_path / "j1.tsv", "float32", 1)
    b = jax_rows(run, ckpt, tmp_path / "j2.tsv", "float32", 2)
    assert [r[:6] for r in a] == [r[:6] for r in b]
    assert all(x[8] == y[8] for x, y in zip(a, b))
    dp = max(abs(float(x[7]) - float(y[7])) for x, y in zip(a, b))
    assert dp <= 2e-6
    with capsys.disabled():
        print(f"\nJAX fused float32, --nproc 1 vs 2: "
              f"{sum(x != y for x, y in zip(a, b))} of {len(a)} rows "
              f"differ, max |dP1| {dp:.3g}")
