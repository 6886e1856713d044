"""The port's fast5 reader (deepsignal_plant_tpu_torch/io/fast5.py, on its
own HDF5 reader) against the JAX package's h5py reader, field for field,
on synth_fast5_dir runs and on the port's own writer's files; the skip,
multi-read and corrupt-file cases; get_fast5s."""
import os

import h5py
import numpy as np
import pytest

from deepsignal_plant_tpu.io import fast5 as jax_fast5
from deepsignal_plant_tpu.utils.fileio import get_fast5s as jax_get_fast5s
from deepsignal_plant_tpu_torch.io import fast5
from deepsignal_plant_tpu_torch.io.hdf5 import HDF5FormatError
from deepsignal_plant_tpu_torch.utils.fileio import get_fast5s
from make_synthetic import synth_fast5_dir, synth_genome

FIELDS = ("readname", "read_strand", "alignstrand", "chrom", "chrom_start",
          "raw_signal", "event_starts", "event_lengths", "seq")


def assert_same_read(got, want):
    for k in FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, k


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("f5")
    rng = np.random.default_rng(21)
    genome = synth_genome(rng, {"chr1": 3000, "chr2": 2500})
    synth_fast5_dir(str(tmp / "run"), genome, rng, n_reads=6, read_len=400,
                    max_event_len=25, meth_mode="mixed")
    return str(tmp / "run")


def test_reads_match_jax_reader(run_dir):
    paths = sorted(get_fast5s(run_dir))
    assert len(paths) == 6
    strands = set()
    for p in paths:
        got = fast5.read_tombo_fast5(p)
        assert_same_read(got, jax_fast5.read_tombo_fast5(p))
        strands.add(got.alignstrand)
    assert strands == {"+", "-"}


@pytest.mark.parametrize("rel,strand", [(0, "+"), (37, "-"), (5, "+")])
def test_port_writer_round_trip_matches_jax_reader(tmp_path, rel, strand):
    """The port's writer: the JAX (h5py) reader and the port's reader see
    the same read, read_start_rel_to_raw included."""
    rng = np.random.default_rng(rel)
    n = 150
    lens = rng.integers(3, 20, n)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    raw = rng.integers(300, 700, int(lens.sum()) + rel).astype(np.int16)
    bases = "".join(rng.choice(list("ACGT"), n))
    path = str(tmp_path / "w.fast5")
    fast5.write_tombo_fast5(path, "read_x", raw, bases, starts, lens,
                            "chr9", 4321, alignstrand=strand,
                            read_start_rel_to_raw=rel)
    got = fast5.read_tombo_fast5(path)
    want = jax_fast5.read_tombo_fast5(path)
    assert_same_read(got, want)
    assert got.event_starts[0] == rel and got.seq == bases
    # and the JAX writer's file reads the same through the port
    jpath = str(tmp_path / "j.fast5")
    jax_fast5.write_tombo_fast5(jpath, "read_x", raw, bases, starts, lens,
                                "chr9", 4321, alignstrand=strand,
                                read_start_rel_to_raw=rel)
    assert_same_read(fast5.read_tombo_fast5(jpath), want)


def test_no_alignment_is_none(tmp_path):
    path = str(tmp_path / "noalign.fast5")
    with h5py.File(path, "w") as f:
        g = f.create_group("Raw/Reads/Read_0")
        g.attrs["read_id"] = np.bytes_("r")
        g.create_dataset("Signal", data=np.arange(10, dtype=np.int16))
    assert fast5.read_tombo_fast5(path) is None
    assert jax_fast5.read_tombo_fast5(path) is None


def test_multi_read_container_raises(tmp_path):
    path = str(tmp_path / "multi.fast5")
    with h5py.File(path, "w") as f:
        for i in range(2):
            g = f.create_group(f"read_{i:04d}/Raw")
            g.create_dataset("Signal", data=np.arange(5, dtype=np.int16))
    with pytest.raises(fast5.MultiReadFast5Error):
        fast5.read_tombo_fast5(path)
    with pytest.raises(jax_fast5.MultiReadFast5Error):
        jax_fast5.read_tombo_fast5(path)


def test_missing_channel_keeps_raw_values(tmp_path):
    path = str(tmp_path / "nochan.fast5")
    rng = np.random.default_rng(2)
    jax_fast5.write_tombo_fast5(path, "r", rng.integers(0, 9, 40), "ACGTA",
                                np.arange(5) * 8, np.full(5, 8), "c", 0)
    with h5py.File(path, "a") as f:
        del f["UniqueGlobalKey"]
    got = fast5.read_tombo_fast5(path)
    assert_same_read(got, jax_fast5.read_tombo_fast5(path))
    assert got.raw_signal.dtype == np.float64


def test_corrupt_file_is_counted_not_fatal(tmp_path, run_dir):
    """extract over a run with a corrupt fast5 and one whose VBZ chunk is
    no VBZ stream counts both as failed and still writes the good reads'
    rows."""
    import shutil

    from deepsignal_plant_tpu_torch.pipeline.extract import (
        ExtractContext, ExtractOptions, extract_features)
    d = tmp_path / "run"
    shutil.copytree(run_dir, d)
    (d / "broken.fast5").write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(100))
    with h5py.File(d / "vbz.fast5", "w") as f:
        ds = f.create_dataset("Raw/Reads/Read_0/Signal", shape=(16,),
                              dtype=np.int16, chunks=(16,),
                              compression=32020, allow_unknown_filter=True)
        ds.id.write_direct_chunk((0,), b"\x00" * 32)
        f["Raw/Reads/Read_0"].attrs["read_id"] = np.bytes_("v")
        al = f.create_group("Analyses/RawGenomeCorrected_000/"
                            "BaseCalled_template/Alignment")
        al.attrs["mapped_strand"] = np.bytes_("+")
    with pytest.raises(HDF5FormatError, match="VBZ") as exc:
        fast5.read_tombo_fast5(str(d / "vbz.fast5"))
    assert not isinstance(exc.value, fast5.VBZPluginError)
    ctx = ExtractContext.build(ExtractOptions())
    out = str(tmp_path / "f.tsv")
    n, errors = extract_features(str(d), True, ctx, out, nproc=1)
    assert (n, errors) == (8, 2)
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("recursive", [True, False])
def test_get_fast5s_matches_jax(tmp_path, recursive):
    (tmp_path / "a" / "b").mkdir(parents=True)
    for p in ("x.fast5", "a/y.fast5", "a/b/z.fast5", "a/not.txt",
              "w.fast5.tmp"):
        (tmp_path / p).write_bytes(b"")
    got = get_fast5s(str(tmp_path), recursive)
    assert got == jax_get_fast5s(str(tmp_path), recursive)
    assert len(got) == (3 if recursive else 1)
