#!/usr/bin/env python3
"""Write the fast5 feature fixtures (tests/data/fast5_features/): one
single-read tombo fast5 in h5py's default layout (``plain.fast5``: every
dataset contiguous) and the same read once per HDF5 feature that fast5
writers (MinKNOW, ont_fast5_api, Guppy, tombo) add on the read's path,
each read by the port's own HDF5 reader (deepsignal_plant_tpu_torch/
io/hdf5.py) as h5py reads it:

    bool_attr            a numpy bool attribute (h5py's boolean enum)
    enum_attr            ``end_reason`` as an enumeration on uint8
    vlen_seq_attr        a variable-length int32 sequence attribute
    committed_dtype      Signal written with a committed (named) datatype
    soft_link            UniqueGlobalKey a soft link (symbol-table group)
    soft_link_latest     the same at libver="latest" (a Link message)
    external_link        UniqueGlobalKey an external link to
                         external_link_meta.h5 beside it
    lzf, nbit,           Signal chunked through LZF (32000), N-bit (5; the
    scaleoffset, szip    int16 at 12 bits), scale-offset (6) and szip (4)
    sohm                 a shared object header message table (datatypes,
                         dataspaces and attributes in its heap)
    filtered_heap        Raw/Reads/Read_0's links in a fractal heap through
                         deflate (one a huge object), its attributes and
                         Signal's dense

h5py's API does not write the last two; they go through its bundled
libhdf5 by ctypes (H5Pset_shared_mesg_*, H5Pset_deflate on a group
creation property list: libhdf5 1.14 filters the link heap of such a
group, not its attribute heap). Needs h5py; run from the repository root:

    python tests/make_fast5_features.py [out_dir]

The card's machine has no h5py: chip_smoke.py's phase 6d reads the
committed files.
"""
from __future__ import annotations

import ctypes
import glob
import os
import sys

import h5py
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "fast5_features")
SEED = 18
READ_LEN = 2_000              # bases of the read
CHUNK = 4_000                 # samples a Signal chunk (the last partial)
READ_ID = "f5feature-0001"
END_REASONS = {"unknown": 0, "partial": 1, "mux_change": 2,
               "unblock_mux_change": 3, "signal_positive": 4,
               "signal_negative": 5}


def libhdf5() -> ctypes.CDLL:
    """h5py's bundled libhdf5 (already loaded by ``import h5py``)."""
    libs = os.path.join(os.path.dirname(os.path.dirname(h5py.__file__)),
                        "h5py.libs")
    found = glob.glob(os.path.join(libs, "libhdf5-*.so*")) or \
        glob.glob(os.path.join(os.path.dirname(h5py.__file__),
                               "libhdf5*.so*"))
    if not found:
        raise RuntimeError("h5py's libhdf5 not found")
    return ctypes.CDLL(found[0])


def the_read() -> dict:
    """The seeded read: READ_LEN bases of a random contig window, events
    of 3-20 samples, DAC 300-699 (synth_fast5_dir's model)."""
    rng = np.random.default_rng(SEED)
    bases = "".join(rng.choice(list("ACGT"), READ_LEN))
    lens = rng.integers(3, 21, READ_LEN)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    ev = np.zeros(READ_LEN, dtype=[("start", "<i8"), ("length", "<i8"),
                                   ("base", "S1")])
    ev["start"], ev["length"] = starts, lens
    ev["base"] = np.frombuffer(bases.encode(), "S1")
    raw = rng.integers(300, 700, int(lens.sum())).astype(np.int16)
    return {"signal": raw, "events": ev}


def write_read(f: h5py.File, read: dict, signal=None, channel=True,
               read_attrs: dict | None = None, read_group=None) -> None:
    """The tombo layout into ``f``: ``signal(group, data)`` creates
    Signal (default contiguous), ``channel`` False leaves
    UniqueGlobalKey out (the caller links it), ``read_attrs`` are
    extra attributes of Raw/Reads/Read_0, ``read_group(parent)`` creates
    that group."""
    reads = f.require_group("Raw/Reads")
    rg = read_group(reads) if read_group else reads.create_group("Read_0")
    rg.attrs["read_id"] = np.bytes_(READ_ID)
    for k, v in (read_attrs or {}).items():
        rg.attrs[k] = v
    if signal is None:
        rg.create_dataset("Signal", data=read["signal"])
    else:
        signal(rg, read["signal"])
    if channel:
        write_channel(f.create_group("UniqueGlobalKey"))
    corr = f.create_group("Analyses/RawGenomeCorrected_000/"
                          "BaseCalled_template")
    al = corr.create_group("Alignment")
    al.attrs["mapped_strand"] = np.bytes_("+")
    al.attrs["mapped_chrom"] = np.bytes_("chr1")
    al.attrs["mapped_start"] = np.int64(1000)
    ev = corr.create_dataset("Events", data=read["events"])
    ev.attrs["read_start_rel_to_raw"] = np.int64(0)


def write_channel(g: h5py.Group) -> None:
    ch = g.create_group("channel_id")
    ch.attrs["digitisation"] = 8192.0
    ch.attrs["range"] = 1465.0
    ch.attrs["offset"] = 10.0


def chunked(**kw):
    def make(g, data):
        g.create_dataset("Signal", data=data, chunks=(CHUNK,), **kw)
    return make


def nbit_signal(g, data):
    """Signal as an int16 of 12 significant bits through N-bit."""
    tid = h5py.h5t.STD_I16LE.copy()
    tid.set_precision(12)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((CHUNK,))
    dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0)
    ds = h5py.h5d.create(g.id, b"Signal", tid,
                         h5py.h5s.create_simple(data.shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


def committed_signal(g, data):
    g.file["signal_dtype"] = np.dtype("<i2")
    g.create_dataset("Signal", data=data, dtype=g.file["signal_dtype"])


def sohm_file(path: str) -> h5py.File:
    """A file whose messages are shared through the superblock
    extension's shared message table: datatypes and dataspaces in one
    index, attributes of 64 bytes or more in another; each index a list
    up to 2 messages, then a v2 B-tree."""
    lib = libhdf5()
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    hid = ctypes.c_int64(fcpl.id)
    for rc in (lib.H5Pset_shared_mesg_nindexes(hid, 2),
               # flags: 1 << message type (dataspace 1, datatype 3, ...)
               lib.H5Pset_shared_mesg_index(hid, 0, (1 << 1) | (1 << 3), 1),
               lib.H5Pset_shared_mesg_index(hid, 1, 1 << 12, 64),
               lib.H5Pset_shared_mesg_phase_change(hid, 2, 1)):
        if rc < 0:
            raise RuntimeError("H5Pset_shared_mesg_* failed")
    fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    return h5py.File(fid)


def sohm_signal(g, data):
    """Signal after an unwritten dataset of its datatype and shape: the
    first copy of a shareable message stays in its header, Signal's go
    to the shared message heap."""
    g.file.create_dataset("Meta/signal_template", shape=data.shape,
                          dtype=data.dtype)
    g.create_dataset("Signal", data=data)


def dense_signal(g, data):
    """Signal chunked through deflate with 12 attributes and a 160 kB
    one: dense attribute storage in a fractal heap through the dataset's
    own filter pipeline, the large one a huge object."""
    ds = g.create_dataset("Signal", data=data, chunks=(CHUNK,),
                          compression="gzip")
    for i in range(12):
        ds.attrs[f"calibration_{i:02d}"] = np.float64(i) / 7
    ds.attrs["sample_clock"] = np.arange(20_000, dtype=np.int64) % 7


def deflated_group(parent: h5py.Group, name: str = "Read_0"):
    """A group whose links are dense from the first (link phase change
    0/0) in a fractal heap through deflate (a filter pipeline on its
    group creation property list)."""
    lib = libhdf5()
    gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
    hid = ctypes.c_int64(gcpl.id)
    if lib.H5Pset_deflate(hid, 6) < 0 or \
            lib.H5Pset_link_phase_change(hid, 0, 0) < 0:
        raise RuntimeError("H5Pset_deflate / H5Pset_link_phase_change")
    gid = h5py.h5g.create(parent.id, name.encode(), gcpl=gcpl)
    return h5py.Group(gid)


def write_all(out: str) -> list[str]:
    read = the_read()
    os.makedirs(out, exist_ok=True)
    written = []

    def write(name, libver=None, **kw):
        path = os.path.join(out, f"{name}.fast5")
        with h5py.File(path, "w", libver=libver) as f:
            write_read(f, read, **kw)
        written.append(path)
        return path

    write("plain")
    write("bool_attr", read_attrs={"saturated": np.bool_(False),
                                   "is_template": np.array([True, False])})
    path = write("enum_attr")
    with h5py.File(path, "a") as f:
        f["Raw/Reads/Read_0"].attrs.create(
            "end_reason", 4, dtype=h5py.enum_dtype(END_REASONS,
                                                   basetype="u1"))
    path = write("vlen_seq_attr")
    with h5py.File(path, "a") as f:
        f["Raw/Reads/Read_0"].attrs.create(
            "event_offsets", data=np.array(
                [np.arange(3, dtype=np.int32), np.arange(7, dtype=np.int32)
                 * -5, np.zeros(0, np.int32)], dtype=object),
            dtype=h5py.vlen_dtype(np.int32))
    write("committed_dtype", signal=committed_signal)
    for name, libver in (("soft_link", None), ("soft_link_latest",
                                                "latest")):
        path = write(name, libver=libver, channel=False)
        with h5py.File(path, "a", libver=libver) as f:
            write_channel(f.create_group("Meta/UniqueGlobalKey"))
            f["UniqueGlobalKey"] = h5py.SoftLink("/Meta/UniqueGlobalKey")
    meta = os.path.join(out, "external_link_meta.h5")
    with h5py.File(meta, "w") as f:
        write_channel(f.create_group("UniqueGlobalKey"))
    path = write("external_link", channel=False)
    with h5py.File(path, "a") as f:
        f["UniqueGlobalKey"] = h5py.ExternalLink(
            os.path.basename(meta), "/UniqueGlobalKey")
    write("lzf", signal=chunked(compression="lzf", shuffle=True))
    write("nbit", signal=nbit_signal)
    write("scaleoffset", signal=chunked(scaleoffset=0))
    write("szip", signal=chunked(compression="szip",
                                 compression_opts=("nn", 8)))
    path = os.path.join(out, "sohm.fast5")
    with sohm_file(path) as f:
        write_read(f, read, signal=sohm_signal, read_attrs={
            **{f"tag_{i:02d}": np.int64(i) for i in range(6)},
            **{f"context_{i:02d}": np.bytes_(f"value {i} " * 10)
               for i in range(6)}})
    written.append(path)
    path = write("filtered_heap", libver="latest",
                 read_group=deflated_group, signal=dense_signal,
                 read_attrs={f"context_{i:02d}": np.bytes_(f"value {i} " * 20)
                             for i in range(12)})
    with h5py.File(path, "a", libver="latest") as f:
        # a link past the heap's 4 kB managed objects: a huge object,
        # through the heap's filters too
        f["Raw/Reads/Read_0/provenance"] = h5py.SoftLink(
            "/Analyses" + "/RawGenomeCorrected_000" * 300)
    return written + [meta]


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    paths = write_all(out)
    total = sum(os.path.getsize(p) for p in paths)
    print(f"{len(paths)} files, {total} bytes in {out}")
