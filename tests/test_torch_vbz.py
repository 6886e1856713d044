"""VBZ (HDF5 filter 32020) in the port's fast5 reader: the decoder
(deepsignal_plant_tpu_torch/io/vbz.py and native ``dsp_vbz_unpack``)
against hand-worked Stream VByte vectors and the independent numpy
encoder of tests/torch_vbz.py (zstd cross-checked by the ``zstandard``
package here only), and VBZ twins of a tombo run -- written by h5py with
``write_direct_chunk`` and by the port's writer -- against their gzip
twins read by the JAX package: the same reads, the same ``extract``
bytes, the same ``call_mods`` rows."""
from __future__ import annotations

import os

import h5py
import numpy as np
import pytest
import zstandard

import torch_vbz as tv
from deepsignal_plant_tpu import cli as jax_cli
from deepsignal_plant_tpu.io import fast5 as jax_fast5
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.io import fast5, hdf5, vbz
from deepsignal_plant_tpu_torch.native import load
from make_synthetic import synth_fast5_dir, synth_genome
from test_torch_call_mods import NARROW_FLAGS, ckpt  # noqa: F401
from test_torch_fast5 import assert_same_read

SIGNAL = "Raw/Reads/Read_0/Signal"
CHUNK = 1000                  # samples a chunk: reads of 2-8k samples


def unpack(stream: bytes, count: int, isize: int, zigzag: bool):
    out = np.empty(count * isize, np.uint8)
    used = load().dsp_vbz_unpack(stream, len(stream), count, isize,
                                 int(zigzag), out)
    return used, out


def test_streamvbyte_hand_vectors():
    words = np.array([1, 256, 65536, 16777216], np.uint32)
    want = bytes([0xE4, 0x01, 0x00, 0x01, 0x00, 0x00, 0x01,
                  0x00, 0x00, 0x00, 0x01])
    assert tv.streamvbyte_encode(words) == want
    used, out = unpack(want, 4, 4, False)
    assert used == len(want)
    np.testing.assert_array_equal(out.view("<u4"), words)
    # five values: a second control byte, its three unused keys 0
    five = tv.streamvbyte_encode(np.array([7, 0, 300, 9, 70000], np.uint32))
    assert five[:2] == bytes([0b00010000, 0b10]) and len(five) == 2 + 8


def test_zigzag_delta_hand_vector():
    sig = np.array([500, 498, 510], np.int16)
    np.testing.assert_array_equal(tv.zigzag_delta(sig), [1000, 3, 24])
    stream = tv.streamvbyte_encode(np.array([1000, 3, 24], np.uint32))
    assert stream == bytes([0b00000001, 0xE8, 0x03, 0x03, 0x18])
    used, out = unpack(stream, 3, 2, True)
    assert used == len(stream)
    np.testing.assert_array_equal(out.view("<i2"), sig)


def _signal(n: int, isize: int, seed: int) -> np.ndarray:
    info = np.iinfo(f"i{isize}")
    a = np.random.default_rng(seed).integers(
        info.min, info.max, n, endpoint=True).astype(f"<i{isize}")
    ext = [info.max, info.min, -info.max, info.min, info.max]
    a[:min(n, 5)] = ext[:min(n, 5)]
    return a


CDS = [(0, 2, 1, 1), (0, 2, 1, 0), (0, 2, 0, 1), (0, 1, 1, 1),
       (0, 4, 1, 1), (0, 4, 0, 0), (0, 1, 0, 0), (0, 0, 0, 1)]


@pytest.mark.parametrize("cd", CDS, ids=str)
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 58_001])
def test_vbz_round_trip(n, cd):
    isize = cd[1] or 2
    a = _signal(n, isize, n + 7 * cd[1] + cd[3])
    enc = tv.vbz_encode(a.tobytes(), cd)
    assert int.from_bytes(enc[:4], "little") == a.nbytes
    assert vbz.decode_chunk(enc, cd, a.nbytes) == a.tobytes()
    # the zstd layer, by an independent implementation
    inner = tv.streamvbyte_encode(
        tv.zigzag_delta(a) if cd[2] else a.astype(np.int64).astype(
            np.uint32)) if cd[1] else a.tobytes()
    if cd[3]:
        assert zstandard.ZstdDecompressor().decompress(enc[4:]) == inner
        other = a.nbytes.to_bytes(4, "little") + \
            zstandard.ZstdCompressor(level=3).compress(inner)
        assert vbz.decode_chunk(other, cd, a.nbytes) == a.tobytes()
    else:
        assert enc[4:] == inner


def test_vbz_errors_are_format_errors(monkeypatch):
    a = _signal(4001, 2, 1)
    good = tv.vbz_encode(a.tobytes())
    raw0 = tv.vbz_encode(a.tobytes(), (0, 2, 1, 0))
    bad = {
        "header size": (good, a.nbytes + 2),
        "short chunk": (good[:3], a.nbytes),
        "truncated frame": (good[:-7], a.nbytes),
        "no frame": (good[:4] + b"\x00" * 40, a.nbytes),
    }
    for what, (data, n) in bad.items():
        with pytest.raises(hdf5.HDF5FormatError) as exc:
            vbz.decode_chunk(data, tv.MINKNOW, n)
        assert not isinstance(exc.value, hdf5.VBZPluginError), what
    for data in (raw0[:-1], raw0 + b"\x00", raw0[:20]):
        with pytest.raises(hdf5.HDF5FormatError, match="Stream VByte"):
            vbz.decode_chunk(data, (0, 2, 1, 0), a.nbytes)
    with pytest.raises(hdf5.VBZPluginError,
                       match=r"version 1 .*\[1, 2, 1, 1\]"):
        vbz.decode_chunk(good, (1, 2, 1, 1), a.nbytes)
    monkeypatch.setattr(vbz, "ZSTD_LIBRARY", "libzstd-not-here.so.1")
    with pytest.raises(hdf5.VBZPluginError, match="libzstd-not-here"):
        vbz.decode_chunk(good, tv.MINKNOW, a.nbytes)


@pytest.mark.parametrize("chunk", [(1000,), (4096,), (16,)])
def test_vbz_dataset_chunks_h5py_and_port_writer(tmp_path, chunk):
    """Several chunks with a partial last one, stored by h5py's
    write_direct_chunk and by the port's writer: both read back exact,
    and h5py reads the port's gzip-chunked twin."""
    sig = _signal(10_007, 2, chunk[0])
    c = chunk[0]
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w") as f:
        d = f.create_dataset("Signal", shape=sig.shape, dtype="<i2",
                             chunks=chunk, compression=32020,
                             compression_opts=tv.MINKNOW,
                             allow_unknown_filter=True)
        for lo in range(0, len(sig), c):
            part = np.zeros(c, "<i2")
            part[:len(sig[lo:lo + c])] = sig[lo:lo + c]
            d.id.write_direct_chunk((lo,), tv.vbz_encode(part.tobytes()))
    port = str(tmp_path / "port.h5")
    hdf5.write_file(port, {
        "vbz": (hdf5.Chunked(sig, chunk, [(32020, tv.MINKNOW)],
                             tv.chunk_encoder()), {}),
        "gzip": (hdf5.Chunked(sig, chunk, [(1, (4,))]), {})})
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["Signal"][()], sig)
    with hdf5.File(port) as f:
        np.testing.assert_array_equal(f["vbz"][()], sig)
        np.testing.assert_array_equal(f["gzip"][()], sig)
    with h5py.File(port) as f:
        np.testing.assert_array_equal(f["gzip"][()], sig)
        assert f["vbz"].chunks == chunk
        assert f["vbz"]._filters == {"32020": tv.MINKNOW}


# -- twins of a tombo run ----------------------------------------------------

def _fields(path: str) -> dict:
    """What write_tombo_fast5 takes, read from a fast5 with h5py."""
    with h5py.File(path) as f:
        read = f["Raw/Reads/Read_0"]
        corr = f["Analyses/RawGenomeCorrected_000/BaseCalled_template"]
        al, ev = corr["Alignment"].attrs, corr["Events"]
        ch = f["UniqueGlobalKey/channel_id"].attrs
        return dict(
            readname=read.attrs["read_id"].decode(),
            raw_signal=read["Signal"][()],
            bases=b"".join(ev["base"]).decode(),
            event_starts=ev["start"], event_lengths=ev["length"],
            chrom=al["mapped_chrom"].decode(),
            chrom_start=int(al["mapped_start"]),
            alignstrand=al["mapped_strand"].decode(),
            digitisation=float(ch["digitisation"]),
            prange=float(ch["range"]), offset=float(ch["offset"]),
            read_start_rel_to_raw=int(ev.attrs["read_start_rel_to_raw"]))


def h5py_twin(src: str, dst: str, codec: str) -> None:
    """``src`` copied by h5py with its Signal re-stored in CHUNK-sample
    chunks: VBZ through write_direct_chunk, or gzip."""
    with h5py.File(src) as s, h5py.File(dst, "w") as d:
        for k in s:
            s.copy(s[k], d, name=k)
        sig = d[SIGNAL][()]
        del d[SIGNAL]
        if codec == "gzip":
            d.create_dataset(SIGNAL, data=sig, chunks=(CHUNK,),
                             compression="gzip")
            return
        ds = d.create_dataset(SIGNAL, shape=sig.shape, dtype=sig.dtype,
                              chunks=(CHUNK,), compression=32020,
                              compression_opts=tv.MINKNOW,
                              allow_unknown_filter=True)
        for lo in range(0, len(sig), CHUNK):
            part = np.zeros(CHUNK, sig.dtype)
            part[:len(sig[lo:lo + CHUNK])] = sig[lo:lo + CHUNK]
            ds.id.write_direct_chunk((lo,), tv.vbz_encode(part.tobytes()))


def port_twin(src: str, dst: str, codec: str) -> None:
    """The same read written by the port's writer, Signal chunked."""
    filters = [(32020, tv.MINKNOW)] if codec == "vbz" else [(1, (4,))]
    fast5.write_tombo_fast5(
        dst, **_fields(src), signal_chunks=CHUNK, signal_filters=filters,
        signal_encode=tv.chunk_encoder() if codec == "vbz" else None)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """A run of 8 reads (h5py, the JAX package's writer) and its twins:
    VBZ and gzip by h5py, VBZ and gzip by the port's writer."""
    tmp = tmp_path_factory.mktemp("vbz_twins")
    rng = np.random.default_rng(13)
    genome = synth_genome(rng, {"chr1": 4000, "chr2": 3000})
    src = str(tmp / "orig")
    synth_fast5_dir(src, genome, rng, n_reads=8, read_len=400,
                    max_event_len=25, meth_mode="mixed")
    out = {"orig": src}
    for name, make, codec in (("vbz", h5py_twin, "vbz"),
                              ("gzip", h5py_twin, "gzip"),
                              ("port_vbz", port_twin, "vbz"),
                              ("port_gzip", port_twin, "gzip")):
        d = str(tmp / name)
        os.makedirs(d)
        for fn in sorted(os.listdir(src)):
            make(os.path.join(src, fn), os.path.join(d, fn), codec)
        out[name] = d
    return out


def test_twins_read_the_same(twins):
    names = sorted(os.listdir(twins["orig"]))
    for fn in names:
        want = jax_fast5.read_tombo_fast5(os.path.join(twins["gzip"], fn))
        for twin in ("vbz", "port_vbz", "port_gzip", "orig"):
            path = os.path.join(twins[twin], fn)
            assert_same_read(fast5.read_tombo_fast5(path), want)
        with h5py.File(os.path.join(twins["vbz"], fn)) as f:
            assert f[SIGNAL]._filters == {"32020": tv.MINKNOW}
            assert f[SIGNAL].chunks == (CHUNK,)


def _extract(main, src: str, out: str) -> bytes:
    main(["extract", "-i", src, "-o", out, "--nproc", "1",
          "--f5_batch_size", "3"])
    with open(out, "rb") as fh:
        return fh.read()


def test_twins_extract_bytes_match_jax(twins, tmp_path):
    want = _extract(jax_cli.main, twins["gzip"], str(tmp_path / "jax.tsv"))
    assert want.count(b"\n") > 200
    for twin in ("vbz", "port_vbz"):
        got = _extract(cli.main, twins[twin], str(tmp_path / f"{twin}.tsv"))
        assert got == want, twin


def test_twins_call_mods_rows_equal(twins, ckpt, tmp_path):  # noqa: F811
    """CPU call_mods (the fused fast5 path) on the VBZ twins writes the
    rows it writes on the gzip twin."""
    rows = {}
    for twin in ("gzip", "vbz", "port_vbz"):
        out = str(tmp_path / f"{twin}.calls.tsv")
        cli.main(["call_mods", "-i", twins[twin], "-m", ckpt, "-o", out,
                  "--device", "cpu", "--f5_batch_size", "3", "--nproc", "1",
                  *NARROW_FLAGS])
        with open(out, "rb") as fh:
            rows[twin] = sorted(fh.read().splitlines())
    assert len(rows["gzip"]) > 200
    assert rows["vbz"] == rows["gzip"] == rows["port_vbz"]


def test_port_imports_no_zstandard():
    """The port decodes zstd through the system's libzstd.so.1: no module
    of it imports the zstandard package, which only these tests use."""
    import subprocess
    import sys

    from test_torch_package import REPO, port_modules
    code = ("import importlib, sys\n"
            f"for m in {port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print(repr(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'zstandard')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
