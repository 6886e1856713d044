"""The port's HDF5 reader and writer (deepsignal_plant_tpu_torch/io/hdf5.py)
held against h5py: files h5py writes read back exactly (arrays, dtypes,
attributes), h5py reads what the port writes, every refusal is named, and
mutated files give a value or a Python exception within a time limit."""
from __future__ import annotations

import multiprocessing as mp
import os

import h5py
import numpy as np
import pytest

from deepsignal_plant_tpu_torch.io import hdf5

ATTRS = {"bytes": np.bytes_("read_0a1b"), "str": "variable length",
         "int64": np.int64(-1234567890123), "float64": np.float64(1465.25),
         "int32": np.int32(-77)}


def _events(n: int, rng) -> np.ndarray:
    ev = np.zeros(n, dtype=[("start", "<i8"), ("length", "<i8"),
                            ("base", "S1")])
    ev["start"] = np.cumsum(rng.integers(3, 20, n))
    ev["length"] = rng.integers(3, 20, n)
    ev["base"] = rng.choice(list(b"ACGT"), n).astype(np.uint8).view("S1")
    return ev


def _write_h5py(path, libver, storage, rng):
    sig = rng.integers(-2000, 2000, 5003).astype(np.int16)
    kw = {}
    if storage == "compact":
        sig = sig[:300]
    elif storage != "contiguous":
        level, shuffle, fletcher = storage
        kw = dict(chunks=(1024,), compression="gzip",
                  compression_opts=level, shuffle=shuffle,
                  fletcher32=fletcher)
    ev = _events(211, rng)
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("Raw/Reads/Read_7")
        for k, v in ATTRS.items():
            g.attrs[k] = v
        if storage == "compact":
            sid = h5py.h5s.create_simple(sig.shape)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            dsid = h5py.h5d.create(g.id, b"Signal", h5py.h5t.STD_I16LE, sid,
                                   dcpl=dcpl)
            dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, sig)
        else:
            g.create_dataset("Signal", data=sig, **kw)
        d = f.create_dataset("Analyses/Corr/Events", data=ev, **(
            {k: v for k, v in kw.items() if k != "chunks"} | (
                {"chunks": (50,)} if kw else {})))
        d.attrs["read_start_rel_to_raw"] = np.int64(17)
        f["Analyses"].attrs["float_arr"] = np.arange(5, dtype=np.float64)
    return sig, ev


STORAGES = ["compact", "contiguous", (1, False, False), (9, False, False),
            (1, True, False), (9, True, True), (4, False, True)]


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("storage", STORAGES, ids=str)
def test_reader_matches_h5py(tmp_path, libver, storage):
    rng = np.random.default_rng(len(str(storage)) + (libver == "latest"))
    path = str(tmp_path / "f.h5")
    sig, ev = _write_h5py(path, libver, storage, rng)
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        for p in ("Raw/Reads/Read_7/Signal", "Analyses/Corr/Events"):
            got, want = f[p].read(), ref[p][()]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(f["Raw/Reads/Read_7/Signal"][()], sig)
        np.testing.assert_array_equal(f["Analyses/Corr/Events"][()], ev)
        attrs = f["Raw/Reads/Read_7"].attrs
        rattrs = ref["Raw/Reads/Read_7"].attrs
        assert set(attrs) == set(rattrs) == set(ATTRS)
        for k, v in rattrs.items():
            got = attrs[k]
            if isinstance(v, str):
                assert got == v.encode()
            else:
                assert type(got) is type(v) and got == v
                assert np.asarray(got).dtype == np.asarray(v).dtype
        assert f["Analyses/Corr/Events"].attrs == {
            "read_start_rel_to_raw": 17}
        np.testing.assert_array_equal(f["Analyses"].attrs["float_arr"],
                                      np.arange(5.0))
        assert f.keys() == sorted(ref.keys())
        assert f["Raw/Reads"].keys() == ["Read_7"]
        assert "Raw/Reads/Read_7" in f and "Raw/Nope" not in f


def test_reader_partial_last_chunk_2d(tmp_path):
    """Several chunks in two dimensions with partial edge chunks, under
    both B-tree (earliest) and fixed-array (latest) indexes."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(37, 23)).astype(">f4")
    for libver in ("earliest", "latest"):
        path = str(tmp_path / f"{libver}.h5")
        with h5py.File(path, "w", libver=libver) as f:
            f.create_dataset("a", data=a, chunks=(8, 5), compression="gzip",
                             shuffle=True)
            f.create_dataset("b", data=a, chunks=(37, 23))   # single chunk
            f.create_dataset("c", data=a.astype("<u2"), chunks=(10, 10))
        with hdf5.File(path) as f:
            for k in "abc":
                with h5py.File(path) as ref:
                    want = ref[k][()]
                got = f[k][()]
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_writer_read_by_h5py(tmp_path):
    rng = np.random.default_rng(5)
    sig = rng.integers(300, 700, 4000).astype(np.int16)
    ev = _events(120, rng)
    names = {f"child_{i:02d}": (np.arange(i, dtype=np.int64), {})
             for i in range(40)}
    tree = {
        "Raw": {"Reads": {"Read_0": {
            "@attrs": {"read_id": np.bytes_("abc-123")},
            "Signal": (sig, {})}}},
        "UniqueGlobalKey": {"channel_id": {"@attrs": {
            "digitisation": 8192.0, "range": 1465.0, "offset": 10.0}}},
        "Analyses": {"Corr": {"Sub": {
            "Alignment": {"@attrs": {"mapped_strand": np.bytes_("-"),
                                     "mapped_start": 123456}},
            "Events": (ev, {"read_start_rel_to_raw": 5})}}},
        "many": names,
    }
    path = str(tmp_path / "w.h5")
    hdf5.write_file(path, tree)
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["Raw/Reads/Read_0/Signal"][()], sig)
        assert f["Raw/Reads/Read_0/Signal"].dtype == np.int16
        np.testing.assert_array_equal(f["Analyses/Corr/Sub/Events"][()], ev)
        assert f["Analyses/Corr/Sub/Events"].dtype == ev.dtype
        assert f["Raw/Reads/Read_0"].attrs["read_id"] == b"abc-123"
        al = f["Analyses/Corr/Sub/Alignment"].attrs
        assert al["mapped_strand"] == b"-" and al["mapped_start"] == 123456
        assert f["Analyses/Corr/Sub/Events"].attrs[
            "read_start_rel_to_raw"] == 5
        assert f["UniqueGlobalKey/channel_id"].attrs["range"] == 1465.0
        assert list(f["many"].keys()) == sorted(names)
        for k, (arr, _) in names.items():
            np.testing.assert_array_equal(f["many"][k][()], arr)
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["Raw/Reads/Read_0/Signal"][()], sig)
        assert f["many"].keys() == sorted(names)


def test_refuses_dense_storage(tmp_path):
    """Dense link and attribute storage (fractal heaps indexed by v2
    B-trees), once refused by name, read as h5py reads them. The name is
    kept from the refusal this test checked."""
    path = str(tmp_path / "dense.h5")
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("links")
        for i in range(12):
            g.create_group(f"g{i}")
        a = f.create_group("attrs")
        for i in range(12):
            a.attrs[f"a{i}"] = i
    with h5py.File(path) as ref, hdf5.File(path) as f:
        assert f["links"].keys() == list(ref["links"].keys())
        assert list(f["attrs"].attrs.items()) == list(
            ref["attrs"].attrs.items())


def test_refuses_extensible_array_index(tmp_path):
    """The extensible-array chunk index (a dataset with an unlimited
    dimension), once refused by name, reads as h5py reads it."""
    path = str(tmp_path / "ext.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(100), maxshape=(None,),
                         chunks=(10,))
    with h5py.File(path) as ref, hdf5.File(path) as f:
        got = f["x"][()]
        assert got.dtype == ref["x"].dtype
        np.testing.assert_array_equal(got, ref["x"][()])


def test_refuses_paged_fixed_array(tmp_path):
    """A paged fixed-array chunk index (more than 1,024 chunks), once
    refused by name, reads as h5py reads it."""
    path = str(tmp_path / "paged.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3000, dtype=np.int8),
                         chunks=(2,))
    with h5py.File(path) as ref, hdf5.File(path) as f:
        got = f["x"][()]
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, ref["x"][()])


def test_vbz_filter_raises_vbz_error(tmp_path, monkeypatch):
    """A VBZ chunk that is no VBZ stream raises the format error; without
    the system's zstd library a VBZ dataset raises VBZPluginError, never
    a partial or zero signal."""
    import torch_vbz

    from deepsignal_plant_tpu_torch.io import vbz
    path = str(tmp_path / "vbz.h5")
    sig = np.arange(-8, 8, dtype=np.int16) * 999
    with h5py.File(path, "w") as f:
        d = f.create_dataset("Signal", shape=(16,), dtype=np.int16,
                             chunks=(16,), compression=32020,
                             allow_unknown_filter=True)
        d.id.write_direct_chunk((0,), b"\x00" * 32)
        d = f.create_dataset("Good", shape=(16,), dtype=np.int16,
                             chunks=(16,), compression=32020,
                             compression_opts=torch_vbz.MINKNOW,
                             allow_unknown_filter=True)
        d.id.write_direct_chunk((0,), torch_vbz.vbz_encode(sig.tobytes()))
    with hdf5.File(path) as f:
        with pytest.raises(hdf5.HDF5FormatError, match="VBZ") as exc:
            f["Signal"][()]
        assert not isinstance(exc.value, hdf5.VBZPluginError)
        np.testing.assert_array_equal(f["Good"][()], sig)
    monkeypatch.setattr(vbz, "ZSTD_LIBRARY", "libzstd-not-here.so.1")
    with hdf5.File(path) as f:
        with pytest.raises(hdf5.VBZPluginError,
                           match="libzstd-not-here.so.1"):
            f["Good"][()]


def test_not_hdf5(tmp_path):
    p = tmp_path / "x.fast5"
    p.write_bytes(b"not an hdf5 file" * 10)
    with pytest.raises(hdf5.HDF5FormatError):
        hdf5.File(str(p))


def test_lookup3_known_values():
    # Bob Jenkins' published hashlittle self-test values
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551
    assert hdf5.lookup3(b"Four score and seven years ago", 1) == 0xCD628161


def _read_mutants(paths, q):
    """Child process: read each file, report (path, outcome) as it
    ends; None after the last."""
    from deepsignal_plant_tpu_torch.io.fast5 import read_tombo_fast5
    for p in paths:
        try:
            r = read_tombo_fast5(p)
            q.put((p, "none" if r is None else "read"))
        except Exception as exc:  # noqa: BLE001 - any Python exception is fine
            q.put((p, type(exc).__name__))
    q.put(None)


def test_mutated_fast5_never_hangs_or_crashes(tmp_path):
    """Byte mutations (and truncations) of a valid fast5 give a
    TomboRead, None or a Python exception, each file within a time limit:
    one spawned child reads them in turn and reports each as it ends, so
    a hang or a crash shows as a missing report."""
    import queue

    from deepsignal_plant_tpu_torch.io.fast5 import write_tombo_fast5
    rng = np.random.default_rng(11)
    src = str(tmp_path / "ok.fast5")
    lens = rng.integers(3, 12, 80)
    write_tombo_fast5(src, "r0", rng.integers(300, 700, int(lens.sum())),
                      "".join(rng.choice(list("ACGT"), 80)),
                      np.concatenate([[0], np.cumsum(lens)[:-1]]), lens,
                      "chr1", 100)
    data = bytearray(open(src, "rb").read())
    paths = []
    for i in range(120):
        m = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
        if i % 10 == 9:
            m = m[:int(rng.integers(8, len(m)))]
        p = str(tmp_path / f"m{i}.fast5")
        open(p, "wb").write(m)
        paths.append(p)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_read_mutants, args=(paths, q))
    proc.start()
    outcomes = {}
    try:
        for i, p in enumerate(paths):
            try:
                got = q.get(timeout=60 if i == 0 else 10)
            except queue.Empty:
                pytest.fail(f"{os.path.basename(p)} hung or crashed the "
                            f"reader (exit code {proc.exitcode})")
            assert got[0] == p
            outcomes[p] = got[1]
        assert q.get(timeout=10) is None
        proc.join(10)
        assert not proc.is_alive() and proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert "read" in outcomes.values()


@pytest.mark.parametrize("sizes", [(4, 4), (2, 4), (4, 8)])
def test_reader_superblock_sizes(tmp_path, sizes):
    """Sizes of offsets and lengths other than 8."""
    path = str(tmp_path / "s.h5")
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(*sizes)
    fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    rng = np.random.default_rng(9)
    a = rng.integers(0, 1000, 3001).astype("<i4")
    with h5py.File(fid) as f:
        f.create_dataset("g/a", data=a, chunks=(700,), compression="gzip")
        f["g"].attrs["s"] = np.bytes_("xyz")
    with hdf5.File(path) as f:
        assert (f.so, f.sl) == sizes
        np.testing.assert_array_equal(f["g/a"][()], a)
        assert f["g"].attrs["s"] == b"xyz"


def test_reader_superblock_version2(tmp_path):
    path = str(tmp_path / "v108.h5")
    with h5py.File(path, "w", libver=("v108", "v108")) as f:
        f.create_dataset("x", data=np.arange(10.0))
        f["x"].attrs["k"] = np.int32(4)
    assert open(path, "rb").read(9)[8] == 2
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["x"][()], np.arange(10.0))
        assert f["x"].attrs["k"] == 4
