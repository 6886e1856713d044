"""The parts of HDF5 that fast5 writers add on a read's path, read by the
port's reader (deepsignal_plant_tpu_torch/io/hdf5.py, io/h5filters.py)
and held against h5py: enumerations (h5py's booleans), opaque,
bitfield and array types, variable-length sequences and compound
members, integers of reduced precision; committed datatypes and the
shared object header message table; soft, external and user-defined
links; fractal heaps through filters; the LZF, N-bit, scale-offset and
szip filters, bit for bit. Each case writes a small file with h5py (the
table and the filtered heaps through h5py's libhdf5 by ctypes) and reads
it whole with both: keys, link targets, attributes (order, values,
dtypes, Python types) and datasets. What stays refused is named and
raised only on access. Then the committed fixtures
(tests/data/fast5_features/, tests/make_fast5_features.py) read field
for field as the plain read and as the JAX package reads them,
``extract --nproc 4`` on them writes the JAX package's bytes, call_mods
agrees with the JAX package's, and mutated files of each new structure
return or raise within a time limit."""
from __future__ import annotations

import ctypes
import os
import shutil
import struct

import h5py
import numpy as np
import pytest

import make_fast5_features as mk
from deepsignal_plant_tpu import cli as jax_cli
from deepsignal_plant_tpu.io import fast5 as jax_fast5
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.io import fast5, hdf5
from test_torch_fast5 import assert_same_read
from torch_hdf5_walk import OUTCOMES, mutants, walk_file, walk_mutants

FIXTURES = mk.OUT
FEATURES = ("bool_attr", "enum_attr", "vlen_seq_attr", "committed_dtype",
            "soft_link", "soft_link_latest", "external_link", "lzf", "nbit",
            "scaleoffset", "szip", "sohm", "filtered_heap")


def hid(obj) -> ctypes.c_int64:
    """The HDF5 id of an h5py object or property list, for ctypes."""
    return ctypes.c_int64(obj.id if isinstance(obj.id, int) else obj.id.id)


# -- comparing a file read by h5py and by the port -------------------------

def same(got, want) -> bool:
    """The port's value ``got`` is h5py's ``want``: equal values of the
    same dtype and Python type (h5py's str of a variable-length string
    is the port's bytes)."""
    if isinstance(want, str):
        return type(got) is bytes and got == want.encode()
    if isinstance(want, np.ndarray):
        if not isinstance(got, np.ndarray) or got.shape != want.shape or \
                got.dtype != want.dtype:
            return False
        if want.dtype.names:
            return all(same(got[n], want[n]) for n in want.dtype.names)
        if want.dtype == object:
            return all(same(g, w) for g, w in zip(got.reshape(-1),
                                                  want.reshape(-1)))
        return np.array_equal(got, want, equal_nan=want.dtype.kind in "fc")
    if isinstance(want, np.void) and want.dtype.names:
        return isinstance(got, np.void) and got.dtype == want.dtype and all(
            same(got[n], want[n]) for n in want.dtype.names)
    if type(got) is not type(want):
        return False
    return bool(got == want) or (got != got and want != want)


def assert_same_file(path: str) -> int:
    """Walk ``path`` with h5py and with the port in step; the number of
    objects compared."""
    seen: set = set()
    with h5py.File(path) as ref, hdf5.File(path) as f:
        def group(r, g):
            key = (id(g.file), g.addr)
            if key in seen:
                return
            seen.add(key)
            attrs(r, g)
            assert g.keys() == list(r.keys()), r.name
            for k in r.keys():
                assert (k in g) == (k in r), f"{r.name}/{k}"
                try:
                    rc = r[k]
                except (KeyError, RuntimeError):
                    # h5py: KeyError for a dangling link, RuntimeError
                    # past 16 links; the port: KeyError for both
                    with pytest.raises(KeyError):
                        g[k]
                    continue
                c = g[k]
                if isinstance(rc, h5py.Group):
                    assert isinstance(c, hdf5.Group), rc.name
                    group(rc, c)
                elif isinstance(rc, h5py.Dataset):
                    assert isinstance(c, hdf5.Dataset), rc.name
                    attrs(rc, c)
                    got, want = c[()], rc[()]
                    assert same(got, want), (rc.name, got, want)
                    seen.add((id(c.file), c.addr))
                else:
                    assert isinstance(c, hdf5.Datatype), rc.name
                    assert c.dtype == rc.dtype
                    attrs(rc, c)

        def attrs(r, o):
            assert list(o.attrs) == list(r.attrs), r.name
            for k in r.attrs:
                got, want = o.attrs[k], r.attrs[k]
                assert same(got, want), (r.name, k, got, want)
        group(ref, f.root)
    return len(seen)


# -- the cases: one file per structure --------------------------------------

def case_bool(path):
    with h5py.File(path, "w") as f:
        g = f.create_group("Raw/Reads/Read_0")
        g.attrs["saturated"] = np.bool_(True)
        g.attrs["flags"] = np.array([[True, False], [False, True]])
        f.create_dataset("mask", data=np.arange(11) % 3 == 0)
        f.create_dataset("mask_chunked", data=np.arange(100) % 7 == 0,
                         chunks=(30,), compression="gzip")


def case_enum(path):
    with h5py.File(path, "w") as f:
        g = f.create_group("Raw/Reads/Read_0")
        g.attrs.create("end_reason", 4, dtype=h5py.enum_dtype(
            mk.END_REASONS, basetype="u1"))
        e = h5py.enum_dtype({"négatif": -300, "zero": 0, "big": 30000},
                            basetype=">i2")
        g.attrs.create("levels", np.array([-300, 0, 30000], ">i2"), dtype=e)
        f.create_dataset("states", data=np.array([1, 0, 2, 2], "u1"),
                         dtype=h5py.enum_dtype({"a": 0, "b": 1, "c": 2},
                                               basetype="u1"))


def case_vlen(path):
    with h5py.File(path, "w") as f:
        g = f.create_group("g")
        seqs = np.empty(3, object)
        seqs[:] = [np.arange(3, dtype=np.int32), np.zeros(0, np.int32),
                   np.arange(9, dtype=np.int32) * -7]
        g.attrs.create("offsets", data=seqs, dtype=h5py.vlen_dtype(np.int32))
        one = np.empty((), object)
        one[()] = np.arange(4.0)
        g.attrs.create("one", one, dtype=h5py.vlen_dtype(np.float64))
        g.attrs["names"] = ["a", "bcd", ""]
        d = f.create_dataset("ragged", shape=(4,),
                             dtype=h5py.vlen_dtype(np.dtype("<u2")))
        for i in range(4):
            d[i] = np.arange(i * 3, dtype="<u2")
        s = f.create_dataset("strings", shape=(3,),
                             dtype=h5py.string_dtype())
        s[:] = ["x", "yz", "long " * 30]
        cd = np.dtype([("id", "<i4"), ("vals", h5py.vlen_dtype(np.int16))])
        c = f.create_dataset("compound_seq", shape=(3,), dtype=cd)
        for i in range(3):
            c[i] = (i, np.arange(i + 1, dtype=np.int16))


def case_opaque_bitfield(path):
    with h5py.File(path, "w") as f:
        g = f.create_group("g")
        g.attrs["blob"] = np.void(b"\x01\x02\x03\x04\x05")
        f.create_dataset("blobs", data=np.array([b"ab", b"cd"], "V2"))
        stamps = np.array([1, 2, 3], "datetime64[ns]")
        f.create_dataset("stamps", data=stamps.astype(
            h5py.opaque_dtype(stamps.dtype)))
        for name, tid, data in (
                ("bits8", h5py.h5t.STD_B8LE, np.array([1, 2, 255], "u1")),
                ("bits16", h5py.h5t.STD_B16BE, np.array([1, 513], ">u2"))):
            a = h5py.h5a.create(g.id, name.encode(), tid,
                                h5py.h5s.create_simple(data.shape))
            a.write(data)
            d = h5py.h5d.create(f.id, name.encode(), tid,
                                h5py.h5s.create_simple(data.shape))
            d.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def case_array(path):
    with h5py.File(path, "w") as f:
        g = f.create_group("g")
        g.attrs.create("pairs", np.arange(6, dtype="<i4").reshape(2, 3),
                       dtype=np.dtype(("<i4", (3,))))
        g.attrs.create("scalar_arr", np.arange(4.0), dtype=np.dtype(
            ("<f8", (4,))))
        grid = f.create_dataset("grid", shape=(4,), dtype=np.dtype(
            ("<f8", (2, 3))))
        grid[...] = np.arange(24.0).reshape(4, 2, 3)
        ct = np.dtype([("pos", "<i8"), ("window", "<f4", (3,)),
                       ("kmer", "S5"), ("inner", [("a", "u1"),
                                                  ("b", ">i2", (2,))])])
        data = np.zeros(5, ct)
        data["pos"] = np.arange(5)
        data["window"] = np.arange(15).reshape(5, 3)
        data["kmer"] = [b"ACGTA", b"CC", b"G", b"TTTTT", b""]
        data["inner"]["b"] = np.arange(10).reshape(5, 2)
        f.create_dataset("sites", data=data, chunks=(2,), compression="gzip")
        g.attrs["site"] = data[1]


def case_reduced_precision(path):
    """Integers of 12 and 20 significant bits at bit offsets, no filter:
    h5py widens them (sign-extended) to their type's full precision."""
    rng = np.random.default_rng(4)
    with h5py.File(path, "w") as f:
        for name, base, prec, off, data in (
                ("i16_p12", h5py.h5t.STD_I16LE, 12, 0,
                 rng.integers(-2048, 2048, 50).astype("<i2")),
                ("i32be_p20_o5", h5py.h5t.STD_I32BE, 20, 5,
                 rng.integers(-2 ** 19, 2 ** 19, 50).astype(">i4")),
                ("u8_p5_o2", h5py.h5t.STD_U8LE, 5, 2,
                 rng.integers(0, 32, 50).astype("u1"))):
            tid = base.copy()
            tid.set_precision(prec)
            tid.set_offset(off)
            d = h5py.h5d.create(f.id, name.encode(), tid,
                                h5py.h5s.create_simple(data.shape))
            d.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def case_committed(path, libver=None):
    with h5py.File(path, "w", libver=libver) as f:
        f["types/signal"] = np.dtype("<i2")
        f["types/event"] = np.dtype([("start", "<i8"), ("base", "S1")])
        f["types/signal"].attrs["unit"] = np.bytes_("DAC")
        g = f.create_group("Raw/Reads/Read_0")
        g.create_dataset("Signal", data=np.arange(-50, 50, dtype="<i2"),
                         dtype=f["types/signal"])
        ev = np.zeros(4, f["types/event"].dtype)
        ev["start"] = [0, 3, 9, 20]
        g.create_dataset("Events", data=ev, dtype=f["types/event"])
        g.attrs.create("offset", -7, dtype=f["types/signal"])
        g.attrs.create("first", ev[0], dtype=f["types/event"])


def case_sohm(path, btree=False):
    """Datatypes and dataspaces, and attributes of 64 bytes or more, in
    the shared message table's heaps (lists, or v2 B-trees past two
    messages); attributes compact and dense, their own datatypes and
    dataspaces shared."""
    lib = mk.libhdf5()
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    for rc in (lib.H5Pset_shared_mesg_nindexes(hid(fcpl), 2),
               lib.H5Pset_shared_mesg_index(hid(fcpl), 0, 0b1010, 1),
               lib.H5Pset_shared_mesg_index(hid(fcpl), 1, 1 << 12, 64),
               lib.H5Pset_shared_mesg_phase_change(
                   hid(fcpl), *((2, 1) if btree else (50, 40)))):
        assert rc >= 0
    fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    with h5py.File(fid) as f:
        for i in range(6):
            d = f.create_dataset(f"d{i}", data=np.arange(10) * i)
            d.attrs["scale"] = np.float64(i)
            d.attrs["label"] = np.bytes_(f"dataset number {i} " * 4)
        g = f.create_group("dense")
        for i in range(14):
            g.attrs[f"a{i:02d}"] = np.int32(i) if i % 2 else \
                np.bytes_(f"value {i} " * 8)
        f.create_dataset("chunked", data=np.arange(100.0), chunks=(30,),
                         compression="gzip")
        f.create_dataset("chunked2", data=np.arange(100.0) * 2,
                         chunks=(30,), compression="gzip")


def case_soft_links(path, libver=None):
    """Absolute and relative soft links, to groups and datasets, through
    other soft links; dangling; a cycle; chains of 16 soft links (HDF5's
    H5L_NUM_LINKS: read) and 17 (refused)."""
    with h5py.File(path, "w", libver=libver) as f:
        write_channel = mk.write_channel
        write_channel(f.create_group("Meta/UniqueGlobalKey"))
        f.create_dataset("Meta/data", data=np.arange(5))
        f["UniqueGlobalKey"] = h5py.SoftLink("/Meta/UniqueGlobalKey")
        f["Meta/rel"] = h5py.SoftLink("UniqueGlobalKey/channel_id")
        f["Meta/rel_data"] = h5py.SoftLink("data")
        f["via"] = h5py.SoftLink("/Meta/rel")
        f["dangling"] = h5py.SoftLink("/nowhere/at/all")
        f["loop_a"] = h5py.SoftLink("/loop_b")
        f["loop_b"] = h5py.SoftLink("/loop_a")
        for n in (16, 17):                  # chains of n soft links
            f[f"chain{n}_{n - 1}"] = h5py.SoftLink("/Meta/data")
            for i in range(n - 2, 0, -1):
                f[f"chain{n}_{i}"] = h5py.SoftLink(f"/chain{n}_{i + 1}")
            f[f"chain{n}"] = h5py.SoftLink(f"/chain{n}_1")
        f["self_dot"] = h5py.SoftLink("./Meta")


def case_soft_links_latest(path):
    case_soft_links(path, "latest")


def case_external(path):
    """External links: a name relative to the linking file's directory,
    an absolute one, one whose target is a soft link, one to a missing
    file, and one to an object missing in its file."""
    d = os.path.dirname(path)
    meta = os.path.join(d, "meta.h5")
    with h5py.File(meta, "w") as f:
        mk.write_channel(f.create_group("UniqueGlobalKey"))
        f["alias"] = h5py.SoftLink("/UniqueGlobalKey/channel_id")
        f.create_dataset("UniqueGlobalKey/data", data=np.arange(4.0))
    with h5py.File(path, "w") as f:
        f["UniqueGlobalKey"] = h5py.ExternalLink("meta.h5",
                                                 "/UniqueGlobalKey")
        f["absolute"] = h5py.ExternalLink(meta, "/UniqueGlobalKey/data")
        f["through_soft"] = h5py.ExternalLink("meta.h5", "/alias")
        f["missing_file"] = h5py.ExternalLink("no_such_file.h5", "/x")
        f["missing_object"] = h5py.ExternalLink("meta.h5", "/nothing")


def case_filtered_heap(path):
    """A group's links dense in a fractal heap through deflate and
    fletcher32: 300 links (a root indirect block, each entry's filtered size
    and mask) and one past the 4 kB managed objects (a huge object
    through the filters)."""
    lib = mk.libhdf5()
    with h5py.File(path, "w", libver="latest") as f:
        gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
        assert lib.H5Pset_deflate(hid(gcpl), 9) >= 0
        assert lib.H5Pset_fletcher32(hid(gcpl)) >= 0
        g = h5py.Group(h5py.h5g.create(f.id, b"links", gcpl=gcpl))
        for i in range(300):
            if i % 3:
                g.create_group(f"child_{i:03d}")
            else:
                g.create_dataset(f"data_{i:03d}", data=np.arange(i % 5))
        g["huge"] = h5py.SoftLink("/links" + "/child_001" * 600)
        small = mk.deflated_group(f, "small")
        small.create_group("only")


def case_lzf(path):
    rng = np.random.default_rng(1)
    sig = rng.integers(300, 700, 20011).astype("<i2")
    with h5py.File(path, "w") as f:
        f.create_dataset("lzf", data=sig, chunks=(5000,), compression="lzf")
        f.create_dataset("lzf_shuffle", data=sig, chunks=(5000,),
                         compression="lzf", shuffle=True)
        f.create_dataset("lzf_2d", data=rng.normal(size=(37, 23)),
                         chunks=(8, 5), compression="lzf")
        f.create_dataset("lzf_random", data=rng.integers(
            0, 256, 3000).astype("u1"), chunks=(1000,), compression="lzf")
        f.create_dataset("lzf_zeros", data=np.zeros(50000, "<i4"),
                         chunks=(50000,), compression="lzf")


def case_nbit(path):
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        for name, base, prec, off, data in (
                ("i16_p12", h5py.h5t.STD_I16LE, 12, 0,
                 rng.integers(-2048, 2048, 5003).astype("<i2")),
                ("i16_p11_o3", h5py.h5t.STD_I16LE, 11, 3,
                 rng.integers(-1024, 1024, 5003).astype("<i2")),
                ("i32be_p20_o5", h5py.h5t.STD_I32BE, 20, 5,
                 rng.integers(-2 ** 19, 2 ** 19, 3001).astype(">i4")),
                ("u8_p5_o2", h5py.h5t.STD_U8LE, 5, 2,
                 rng.integers(0, 32, 3001).astype("u1")),
                ("u64_p40_o17", h5py.h5t.STD_U64LE, 40, 17,
                 rng.integers(0, 2 ** 40, 999).astype("<u8")),
                ("i16_full", h5py.h5t.STD_I16LE, 16, 0,
                 rng.integers(-2 ** 15, 2 ** 15, 999).astype("<i2"))):
            tid = base.copy()
            tid.set_precision(prec)
            tid.set_offset(off)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((400,))
            dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0)
            d = h5py.h5d.create(f.id, name.encode(), tid,
                                h5py.h5s.create_simple(data.shape),
                                dcpl=dcpl)
            d.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
        # a compound and an array type: N-bit's recursive parameters
        ct = np.dtype([("a", "<i2"), ("b", "<f4"), ("c", "u1", (3,))])
        data = np.zeros(500, ct)
        data["a"] = rng.integers(-999, 999, 500)
        data["b"] = rng.normal(size=500)
        data["c"] = rng.integers(0, 255, (500, 3))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((128,))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0)
        d = h5py.h5d.create(f.id, b"compound", h5py.h5t.py_create(ct),
                            h5py.h5s.create_simple(data.shape), dcpl=dcpl)
        d.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def case_scaleoffset(path):
    """Integers at their fewest bits (fill value 0 defined: zeros take
    the all-ones code), at 4 bits (lossy, as written), all values equal
    with the fill value undefined (minimum bits 0); floats by D-scale,
    with a fill value. (libhdf5 1.14.6 fails to read back a chunk it
    stores at full precision: that case is held bitwise against the
    data written, in test_scaleoffset_full_precision.)"""
    rng = np.random.default_rng(3)
    sig = rng.integers(300, 700, 20011).astype("<i2")
    x = rng.normal(size=5003)
    lib = mk.libhdf5()
    with h5py.File(path, "w") as f:
        f.create_dataset("int_auto", data=sig, chunks=(5000,), scaleoffset=0)
        f.create_dataset("int_zeros", data=np.where(sig > 600, 0, sig),
                         chunks=(5000,), scaleoffset=0)
        f.create_dataset("int_4bits", data=sig, chunks=(5000,),
                         scaleoffset=4)
        f.create_dataset("i64_be", data=rng.integers(
            -2 ** 40, 2 ** 40, 999).astype(">i8"), chunks=(100,),
            scaleoffset=0)
        u16 = rng.integers(0, 30000, 999).astype("<u2")
        u16[::50] = 7
        f.create_dataset("u16_fill7", data=u16, chunks=(100,),
                         scaleoffset=0, fillvalue=7)
        f.create_dataset("f8_d3", data=x, chunks=(1000,), scaleoffset=3)
        f.create_dataset("f4_d2", data=x.astype("f4"), chunks=(1000,),
                         scaleoffset=2)
        f.create_dataset("f4_fill", data=np.where(x > 1, 0, x).astype("f4"),
                         chunks=(1000,), scaleoffset=2, fillvalue=0)
        for name, value in (("equal_i32", 77), ("equal_neg_i32", -5)):
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((1000,))
            dcpl.set_scaleoffset(h5py.h5z.SO_INT, 0)
            assert lib.H5Pset_fill_value(
                hid(dcpl), ctypes.c_int64(h5py.h5t.NATIVE_INT32.id),
                None) >= 0
            d = h5py.h5d.create(f.id, name.encode(), h5py.h5t.STD_I32LE,
                                h5py.h5s.create_simple((2500,)), dcpl=dcpl)
            d.write(h5py.h5s.ALL, h5py.h5s.ALL, np.full(2500, value, "<i4"))


def test_scaleoffset_full_precision(tmp_path):
    """Chunks whose span needs every bit of the type: scale-offset
    stores them as they are (minimum bits = the type's bits), and they
    read as written. h5py's libhdf5 fails on these chunks itself."""
    rng = np.random.default_rng(6)
    path = str(tmp_path / "full.h5")
    data = {"i32": rng.integers(-2 ** 31, 2 ** 31 - 1, 999).astype("<i4"),
            "u8": rng.integers(0, 256, 999).astype("u1"),
            "i16_be": rng.integers(-2 ** 15, 2 ** 15, 999).astype(">i2")}
    data["u8"][:2] = 0, 255
    with h5py.File(path, "w") as f:
        for name, a in data.items():
            f.create_dataset(name, data=a, chunks=(100,), scaleoffset=0)
    with hdf5.File(path) as f:
        for name, a in data.items():
            got = f[name][()]
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, a)


def case_szip(path):
    rng = np.random.default_rng(5)
    sig = rng.integers(300, 700, 20011).astype("<i2")
    x = rng.normal(size=5003)
    with h5py.File(path, "w") as f:
        for mode in ("nn", "ec"):
            for ppb in (8, 16, 32):
                f.create_dataset(f"i16_{mode}_{ppb}", data=sig,
                                 chunks=(5000,), compression="szip",
                                 compression_opts=(mode, ppb))
        f.create_dataset("i16_be", data=sig.astype(">i2"), chunks=(5000,),
                         compression="szip", compression_opts=("nn", 8))
        f.create_dataset("u8", data=rng.integers(0, 255, 999).astype("u1"),
                         chunks=(100,), compression="szip",
                         compression_opts=("ec", 8))
        f.create_dataset("i32", data=sig.astype("<i4") * 1000,
                         chunks=(5000,), compression="szip",
                         compression_opts=("nn", 8))
        f.create_dataset("f4", data=x.astype("<f4"), chunks=(1000,),
                         compression="szip", compression_opts=("nn", 16))
        f.create_dataset("f8", data=x, chunks=(1000,), compression="szip",
                         compression_opts=("nn", 8))
        f.create_dataset("constant", data=np.full(9000, 5, "<i2"),
                         chunks=(9000,), compression="szip",
                         compression_opts=("nn", 8))
        f.create_dataset("smooth", data=(np.arange(9000) // 300).astype(
            "<u2"), chunks=(9000,), compression="szip",
            compression_opts=("ec", 32))
        # a scanline of 23 samples: no whole number of 8-sample blocks
        f.create_dataset("grid", data=rng.integers(0, 999, (37, 23)).astype(
            "<i2"), chunks=(10, 23), compression="szip",
            compression_opts=("nn", 8))


CASES = {"bool": case_bool, "enum": case_enum, "vlen": case_vlen,
         "opaque_bitfield": case_opaque_bitfield, "array": case_array,
         "reduced_precision": case_reduced_precision,
         "committed": case_committed,
         "committed_latest": lambda p: case_committed(p, "latest"),
         "sohm_list": case_sohm,
         "sohm_btree": lambda p: case_sohm(p, btree=True),
         "soft_links": case_soft_links,
         "soft_links_latest": case_soft_links_latest,
         "external": case_external, "filtered_heap": case_filtered_heap,
         "lzf": case_lzf, "nbit": case_nbit, "scaleoffset": case_scaleoffset,
         "szip": case_szip}


@pytest.mark.parametrize("case", sorted(CASES))
def test_feature_reads_as_h5py(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    CASES[case](path)
    assert assert_same_file(path) > 1


def test_structures_are_what_the_cases_say(tmp_path):
    """The cases hold the structures they are named for: messages in the
    shared message heaps (type 1) and in other headers (committed), the
    filtered heap's huge object and indirect root, soft links in symbol
    tables (cache type 2), each filter."""
    paths = {}
    for case in ("sohm_btree", "committed", "filtered_heap", "soft_links",
                 "lzf", "nbit", "scaleoffset", "szip"):
        paths[case] = str(tmp_path / f"{case}.h5")
        CASES[case](paths[case])
    with hdf5.File(paths["sohm_btree"]) as f:
        shared = {(m.mtype, f.buf[m.pos], f.buf[m.pos + 1])
                  for a in (f["d3"].addr, f["dense"].addr)
                  for m in f.messages(a) if m.flags & 2}
        assert {(1, 3, 1), (3, 3, 1)} <= shared
        dict(f["dense"].attrs)
        assert set(f._sohm) == {1, 3, 12}
    with hdf5.File(paths["committed"]) as f:
        assert any(m.flags & 2 for m in f.messages(f["Raw/Reads/Read_0/"
                                                     "Signal"].addr))
    with hdf5.File(paths["filtered_heap"]) as f:
        assert len(f["links"].keys()) == 301
        heaps = [h for h in f._fheaps.values() if h.filters]
        assert heaps and heaps[0].root_rows and heaps[0]._huge
    with hdf5.File(paths["soft_links"]) as f:
        assert f.links(f.root.addr)["UniqueGlobalKey"] == (
            "soft", "/Meta/UniqueGlobalKey")
        assert any(m.mtype == 0x11 for m in f.messages(f.root.addr))
    for case, fid in (("lzf", 32000), ("nbit", 5), ("scaleoffset", 6),
                      ("szip", 4)):
        with h5py.File(paths[case]) as f:
            for d in f.values():
                plist = d.id.get_create_plist()
                assert fid in [plist.get_filter(i)[0]
                               for i in range(plist.get_nfilters())]


def test_version1_compound_array_member(tmp_path):
    """A version 1 compound datatype (HDF5 before 1.4) keeps an array
    member's dimensions in the member itself; no h5py writes one, so its
    message is built here: int16[3] at 0, float32 at 6."""
    path = str(tmp_path / "any.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(3))
    i16 = struct.pack("<B3sIHH", 0x10, b"\x08\x00\x00", 2, 0, 16)
    f32 = struct.pack("<B3sIHHBBBBI", 0x11, b"\x20\x1f\x00", 4, 0, 32,
                      23, 8, 0, 23, 127)

    def member(name, off, dims, t):
        return (name + b"\x00" * (8 - len(name)) + struct.pack(
            "<IB3x4x4x4I", off, len(dims), *(list(dims) + [0] * 4)[:4]) + t)
    msg = struct.pack("<B3sI", 0x16, b"\x02\x00\x00", 10) + member(
        b"a", 0, (3,), i16) + member(b"b", 6, (), f32)
    with hdf5.File(path) as f:
        dt = f.datatype(hdf5._Cursor.over(msg, 8, 8))
        want = np.dtype({"names": ["a", "b"], "formats": [("<i2", (3,)),
                                                          "<f4"],
                         "offsets": [0, 6], "itemsize": 10})
        assert dt.np == want
        raw = np.array([((1, -2, 3), 0.5)], want).tobytes()
        got = f.to_value(dt, (1,), raw)
        assert got["a"].tolist() == [[1, -2, 3]] and got["b"][0] == 0.5


# -- links: HDF5's rules ---------------------------------------------------

def test_soft_link_resolution(tmp_path):
    """h5py's answers on soft links: a relative value from the linking
    group; 16 links taken, a 17th refused; a cycle or a dangling link a
    KeyError (h5py: a RuntimeError past 16 links); ``in`` true for a
    dangling last link (h5py does not follow it), false for a path
    through one (where h5py raises)."""
    path = str(tmp_path / "s.h5")
    case_soft_links(path)
    with h5py.File(path) as ref, hdf5.File(path) as f:
        np.testing.assert_array_equal(f["chain16"][()], np.arange(5))
        np.testing.assert_array_equal(f["Meta/rel_data"][()], np.arange(5))
        assert f["via"].attrs["range"] == 1465.0
        for bad in ("chain17", "loop_a", "dangling", "dangling/x",
                    "loop_a/x"):
            with pytest.raises(KeyError):
                f[bad]
            with pytest.raises((KeyError, RuntimeError)):
                ref[bad]
        for p in ("dangling", "loop_a", "chain17", "chain16", "via/range",
                  "Meta/rel", "/Meta/./data", "self_dot/data", "Meta/data/x",
                  "nope"):
            assert (p in f) == (p in ref), p
        for p in ("dangling/x", "loop_b/y", "chain17/x"):
            with pytest.raises(RuntimeError):
                p in ref
            assert p not in f


def test_external_link_search(tmp_path, monkeypatch):
    """An external link's file: beside the linking file; else in the
    working directory; an absolute name missing there is looked for by
    its last component. A missing file raises ExternalFileMissing (a
    KeyError, as h5py's) naming it; the files opened close with the
    File."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    with h5py.File(b / "cwd_meta.h5", "w") as f:
        f.create_dataset("x", data=np.arange(3))
    with h5py.File(a / "moved_meta.h5", "w") as f:
        f.create_dataset("x", data=np.arange(4))
    path = str(a / "links.h5")
    with h5py.File(path, "w") as f:
        f["cwd"] = h5py.ExternalLink("cwd_meta.h5", "/x")
        f["moved"] = h5py.ExternalLink("/not/here/moved_meta.h5", "/x")
        f["missing"] = h5py.ExternalLink("no_such.h5", "/x")
    monkeypatch.chdir(b)
    with h5py.File(path) as ref, hdf5.File(path) as f:
        for k in ("cwd", "moved"):
            np.testing.assert_array_equal(f[k][()], ref[k][()])
        with pytest.raises(hdf5.ExternalFileMissing, match="no_such.h5"):
            f["missing"]
        assert isinstance(hdf5.ExternalFileMissing("x", []), KeyError)
        assert ("missing" in f) == ("missing" in ref)
        opened = list(f._external.values())
        assert len(opened) == 2
    assert all(o.buf == b"" for o in opened)


@pytest.mark.parametrize("how", ["missing_file", "dangling_soft"])
def test_channel_group_out_of_reach_reads_unscaled(tmp_path, how):
    """UniqueGlobalKey behind an external link to a file that is gone,
    or a dangling soft link: no channel scaling, the raw signal as it is,
    as the JAX package's reader gives it (h5py's KeyError)."""
    path = str(tmp_path / "r.fast5")
    with h5py.File(path, "w") as f:
        mk.write_read(f, mk.the_read(), channel=False)
        f["UniqueGlobalKey"] = h5py.ExternalLink("gone.h5", "/x") \
            if how == "missing_file" else h5py.SoftLink("/gone")
    want = jax_fast5.read_tombo_fast5(path)
    np.testing.assert_array_equal(want.raw_signal,
                                  mk.the_read()["signal"].astype(float))
    assert_same_read(fast5.read_tombo_fast5(path), want)


def _patch_link_type(path: str, name: bytes, old: int, new: int) -> None:
    """The link type byte of the Link message named ``name`` in a file
    of version 1 object headers (no checksum) set to ``new``."""
    buf = bytearray(open(path, "rb").read())
    at = buf.find(bytes([len(name)]) + name)
    assert at > 0
    for back in range(1, 5):
        if buf[at - back] == old:
            buf[at - back] = new
            break
    else:
        raise AssertionError("link type byte not found")
    open(path, "wb").write(bytes(buf))


def test_user_defined_link_refused_by_name(tmp_path):
    """A link of a user-defined class (65-255): listed, refused by name
    on access, as h5py refuses it without a registered class; the file's
    other objects read."""
    path = str(tmp_path / "ud.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=np.arange(3))
        f["custom"] = h5py.ExternalLink("other.h5", "/x")
    _patch_link_type(path, b"custom", 64, 99)
    with h5py.File(path) as ref:
        assert list(ref.keys()) == ["custom", "data"]
        with pytest.raises(Exception):
            ref["custom"]
    with hdf5.File(path) as f:
        assert f.keys() == ["custom", "data"]
        with pytest.raises(hdf5.UnsupportedFeature,
                           match="user-defined link class 99"):
            f["custom"]
        np.testing.assert_array_equal(f["data"][()], np.arange(3))


# -- what stays refused: named, and only on access --------------------------

def _patch_class(path: str, attr: bytes, cls: int) -> None:
    """The datatype class of a version 1 attribute message's type set to
    ``cls`` (the version nibble kept)."""
    buf = bytearray(open(path, "rb").read())
    at = buf.find(attr + b"\x00")
    assert at > 0
    t = at + -(-(len(attr) + 1) // 8) * 8
    buf[t] = (buf[t] & 0xF0) | cls
    open(path, "wb").write(bytes(buf))


def test_refusals_are_named_and_on_access(tmp_path):
    """Time datatypes, object and region references and a filter the
    reader does not decode each raise UnsupportedFeature naming it, only
    when that attribute or dataset is read: the group's other attributes,
    its keys and the read's fields read."""
    path = str(tmp_path / "refused.fast5")
    read = mk.the_read()
    with h5py.File(path, "w") as f:
        mk.write_read(f, read)
        g = f["Raw/Reads/Read_0"]
        g.attrs["when"] = np.int32(1234)
        g.attrs["self"] = g.ref
        g.attrs.create("region", g["Signal"].regionref[2:5],
                       dtype=h5py.regionref_dtype)
        d = f.create_dataset("Raw/Reads/Read_0/Bzip2", shape=(16,),
                             dtype=np.int16, chunks=(16,), compression=307,
                             allow_unknown_filter=True)
        d.id.write_direct_chunk((0,), b"\x00" * 40)
    _patch_class(path, b"when", 2)
    want = jax_fast5.read_tombo_fast5(path)
    assert_same_read(fast5.read_tombo_fast5(path), want)
    with hdf5.File(path) as f:
        g = f["Raw/Reads/Read_0"]
        assert list(g.attrs) == ["read_id", "region", "self", "when"]
        assert g.attrs["read_id"] == mk.READ_ID.encode()
        for k, name in (("when", "time datatype"),
                        ("self", "object reference datatype"),
                        ("region", "region reference datatype")):
            with pytest.raises(hdf5.UnsupportedFeature, match=name):
                g.attrs[k]
        assert g.keys() == ["Bzip2", "Signal"]
        with pytest.raises(hdf5.UnsupportedFeature, match="filter 307"):
            g["Bzip2"][()]


# -- the two repairs: each fails on the reader before them ------------------

def test_symbol_table_soft_link_repair(tmp_path):
    """A soft link in an old-style group (symbol table entry of cache
    type 2) resolves through its value in the local heap; the reader
    before took the entry's undefined object address as the target."""
    path = str(tmp_path / "soft.fast5")
    read = mk.the_read()
    with h5py.File(path, "w") as f:
        mk.write_read(f, read, channel=False)
        mk.write_channel(f.create_group("Meta/UniqueGlobalKey"))
        f["UniqueGlobalKey"] = h5py.SoftLink("/Meta/UniqueGlobalKey")
    assert_same_read(fast5.read_tombo_fast5(path),
                     jax_fast5.read_tombo_fast5(path))


def test_lazy_attributes_repair(tmp_path):
    """An attribute the reader refuses, on the read's group, no longer
    loses the read: attributes decode one by one when asked for, as
    h5py's do; the reader before decoded all of an object's attributes
    at once."""
    path = str(tmp_path / "lazy.fast5")
    with h5py.File(path, "w") as f:
        mk.write_read(f, mk.the_read())
        f["Raw/Reads/Read_0"].attrs["self"] = f["Raw/Reads/Read_0"].ref
    assert_same_read(fast5.read_tombo_fast5(path),
                     jax_fast5.read_tombo_fast5(path))


# -- the committed fixtures --------------------------------------------------

def fixture_paths() -> dict:
    return {n: os.path.join(FIXTURES, f"{n}.fast5")
            for n in ("plain",) + FEATURES}


def test_fixtures_are_complete():
    """Every feature file and the external link's target are committed,
    under 4 MB in all."""
    files = sorted(os.listdir(FIXTURES))
    assert files == sorted([f"{n}.fast5" for n in fixture_paths()]
                           + ["external_link_meta.h5"])
    assert sum(os.path.getsize(os.path.join(FIXTURES, f))
               for f in files) < 4 << 20


@pytest.mark.parametrize("name", FEATURES)
def test_fixture_reads_as_plain(name):
    """A committed feature file reads under h5py (the JAX package's
    reader) as the plain one does, and the port reads it so too, field
    for field; the file itself reads whole as h5py reads it."""
    paths = fixture_paths()
    plain = jax_fast5.read_tombo_fast5(paths["plain"])
    assert_same_read(jax_fast5.read_tombo_fast5(paths[name]), plain)
    assert_same_read(fast5.read_tombo_fast5(paths[name]), plain)
    assert assert_same_file(paths[name]) > 5


def test_fixture_writer_is_deterministic(tmp_path):
    """make_fast5_features.py writes the read the committed files hold."""
    mk.write_all(str(tmp_path))
    for n in ("plain", "nbit", "szip"):
        assert_same_read(fast5.read_tombo_fast5(str(tmp_path / f"{n}.fast5")),
                         fast5.read_tombo_fast5(fixture_paths()[n]))


@pytest.fixture(scope="module")
def mixed_run(tmp_path_factory):
    """The committed fixtures, each under its own read id and contig
    position (so every read's rows are its own), beside a second copy of
    each: 28 reads mixing every feature."""
    d = tmp_path_factory.mktemp("mixed") / "run"
    d.mkdir()
    shutil.copy(os.path.join(FIXTURES, "external_link_meta.h5"), d)
    for k, (name, src) in enumerate(sorted(fixture_paths().items())):
        for copy in range(2):
            dst = d / f"{name}_{copy}.fast5"
            shutil.copy(src, dst)
            with h5py.File(dst, "a") as f:
                rg = f["Raw/Reads/Read_0"]
                rid = f"{name}-{copy}".encode()
                # the same length as the committed id: no group grows
                rg.attrs.modify("read_id", np.bytes_(rid.ljust(
                    len(mk.READ_ID), b"x")[:len(mk.READ_ID)]))
                al = f["Analyses/RawGenomeCorrected_000/BaseCalled_template/"
                       "Alignment"]
                al.attrs.modify("mapped_start", np.int64(1000 + 10_000 * k
                                                         + 5_000 * copy))
                if copy:
                    al.attrs.modify("mapped_strand", np.bytes_("-"))
    return str(d)


def test_mixed_run_extract_matches_jax(mixed_run, tmp_path):
    outs = {}
    for name, main, nproc in (("port4", cli.main, "4"),
                              ("port1", cli.main, "1"),
                              ("jax", jax_cli.main, "1")):
        out = str(tmp_path / f"{name}.tsv")
        main(["extract", "-i", mixed_run, "-o", out, "--nproc", nproc])
        outs[name] = open(out, "rb").read()
    assert outs["port4"].count(b"\n") > 1000
    assert outs["port4"] == outs["port1"] == outs["jax"]


def test_mixed_run_call_mods_matches_jax(mixed_run, tmp_path):
    """call_mods straight on the mixed run, the port's fused path on the
    CPU against the JAX package's: columns 1-6 and 10 identical, both
    probabilities within 2e-6."""
    import jax

    from deepsignal_plant_tpu.config import CallConfig as JaxCallConfig
    from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
    from deepsignal_plant_tpu.models.bilstm import init_params as jax_init
    from deepsignal_plant_tpu.parallel.mesh import make_mesh
    from deepsignal_plant_tpu.pipeline import extract as jax_extract
    from deepsignal_plant_tpu.pipeline.call_mods import \
        CallModsEngine as JaxEngine
    from deepsignal_plant_tpu.models.convert import save_checkpoint
    from test_torch_call_mods import (NARROW, NARROW_FLAGS,
                                      assert_rows_agree, read_rows)
    cfg = JaxModelConfig(**NARROW)
    ckpt = str(tmp_path / "narrow.ckpt.npz")
    save_checkpoint(ckpt, jax_init(jax.random.PRNGKey(7), cfg), cfg)
    out = str(tmp_path / "port.tsv")
    cli.main(["call_mods", "-i", mixed_run, "-m", ckpt, "-o", out,
              "--device", "cpu", "--nproc", "2", "--f5_batch_size", "5",
              "--transfer_dtype", "float32", "--compute_dtype", "float32",
              *NARROW_FLAGS])
    got = sorted(read_rows(out))
    jout = str(tmp_path / "jax.tsv")
    args = jax_cli.build_parser().parse_args(
        ["call_mods", "-i", mixed_run, "-m", ckpt, "-o", jout,
         "--f5_batch_size", "5", "--nproc", "1", "--transfer_dtype",
         "float32"])
    eng = JaxEngine(ckpt, JaxModelConfig(recurrence="scan",
                                         compute_dtype="float32",
                                         dropout_rate=0.0, **NARROW),
                    JaxCallConfig(transfer_dtype="float32"),
                    mesh=make_mesh(jax.devices()[:1]))
    jax_extract.extract_to_call_mods(eng, mixed_run, args, jout)
    want = sorted(read_rows(jout))
    assert len(got) > 1000
    assert_rows_agree(got, want)


# -- mutated files of the new structures -------------------------------------

MUTANT_CASES = {"soft_link_cycle": case_soft_links,
                "external_missing": case_external,
                "filtered_heap": case_filtered_heap, "sohm": case_sohm,
                "committed": case_committed, "vlen": case_vlen,
                "lzf": case_lzf, "nbit": case_nbit,
                "scaleoffset": case_scaleoffset, "szip": case_szip}


@pytest.mark.parametrize("kind", sorted(MUTANT_CASES))
def test_mutated_features_never_hang_or_crash(tmp_path, kind):
    """Byte mutations and truncations of a file of each new structure
    each read whole, or raise HDF5FormatError (or a KeyError where a
    link no longer leads anywhere), within a time limit; the twin of the
    mutation tests of test_torch_hdf5.py and test_torch_hdf5_layouts.py.
    External links of the mutants point into their own directory."""
    src = str(tmp_path / "ok.h5")
    MUTANT_CASES[kind](src)
    assert walk_file(src) > 1
    out = tmp_path / "mutants"
    out.mkdir()
    if os.path.exists(tmp_path / "meta.h5"):
        shutil.copy(tmp_path / "meta.h5", out)
    outcomes = walk_mutants(mutants(src, str(out), 40, len(kind)))
    bad = {p: o for p, o in outcomes.items() if o not in OUTCOMES}
    assert not bad
    assert "HDF5FormatError" in outcomes.values()


def test_lookup3_checks_new_structures(tmp_path):
    """A flipped byte in the shared message table or in a filtered
    heap's indirect block raises a checksum mismatch."""
    for case, sig in (("sohm", b"SMTB"), ("filtered", b"FHIB")):
        path = str(tmp_path / f"{case}.h5")
        (case_sohm if case == "sohm" else case_filtered_heap)(path)
        buf = bytearray(open(path, "rb").read())
        at = buf.find(sig)
        assert at > 0
        buf[at + 20] ^= 0xFF                # a field, not the signature

        open(path, "wb").write(bytes(buf))
        with pytest.raises(hdf5.HDF5FormatError, match="checksum"):
            walk_file(path)


def test_filter_errors_are_named(tmp_path):
    """A chunk that is no stream of its filter raises HDF5FormatError,
    never a zero-filled or partial chunk."""
    path = str(tmp_path / "bad.h5")
    with h5py.File(path, "w") as f:
        for name, kw in (("lzf", dict(compression="lzf")),
                         ("szip", dict(compression="szip",
                                       compression_opts=("nn", 8))),
                         ("so", dict(scaleoffset=0))):
            d = f.create_dataset(name, shape=(64,), dtype="<i2",
                                 chunks=(64,), **kw)
            d.id.write_direct_chunk((0,), struct.pack("<I", 128) + b"\xff")
    with hdf5.File(path) as f:
        for name in ("lzf", "szip", "so"):
            with pytest.raises(hdf5.HDF5FormatError):
                f[name][()]
