"""Decoders of the HDF5 filters beyond deflate, shuffle, fletcher32 and
VBZ that h5py writes or reads: LZF (32000, the filter h5py ships),
N-bit (5), scale-offset (6) and szip (4). The bit-level work is in the
port's native library (native/featparse.cpp: ``dsp_lzf_decompress``,
``dsp_nbit_decode``, ``dsp_scaleoffset_decode``, ``dsp_szip_decode``),
built by g++ at first use; each decoder here checks the filter's client
data values and the decoded size, and raises ``HDF5FormatError`` for a
chunk that does not decode. Nothing returns a partial or zero-filled
chunk.

Each decodes what HDF5's own filter (or, for LZF, h5py's lzf_filter.c,
and for szip libaec's SZ_BufftoBuffDecompress) decodes, bit for bit;
tests/test_torch_hdf5_features.py holds them against h5py.
"""
from __future__ import annotations

import numpy as np

from .hdf5 import HDF5FormatError, UnsupportedFeature, native


def _u32(cd) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(list(cd), np.int64).astype(
        np.uint32))


def _size(n: int, expect: int, where: str) -> int:
    """A decoded size the chunk's parameters give, bounded by the
    chunk's own size (these filters keep a chunk's size)."""
    if n > max(expect, 1 << 16):
        raise HDF5FormatError(f"{where}: a filter says the chunk holds {n} "
                              f"bytes, the chunk is {expect}")
    return n


def lzf(data: bytes, cd, expect: int, where: str) -> bytes:
    """An LZF chunk: h5py's filter decodes into a buffer of the chunk's
    size (client data value 2, else the expected size) and grows it
    while the data run past it."""
    # LZF writes at most 264 bytes for a 3-byte back reference
    limit = 132 * len(data) + 64
    cap = max(expect, min(cd[2] if len(cd) > 2 else 0, limit), 1)
    while True:
        out = np.empty(cap, np.uint8)
        n = native().dsp_lzf_decompress(data, len(data), out, cap)
        if n >= 0:
            return out[:n].tobytes()
        if n == -1:
            raise HDF5FormatError(f"{where}: no LZF stream")
        if cap >= limit:
            raise HDF5FormatError(f"{where}: LZF stream past {cap} bytes")
        cap = min(2 * cap, limit)


def nbit(data: bytes, cd, expect: int, where: str) -> bytes:
    """An N-bit chunk (H5Z__filter_nbit): with the need-not-compress
    flag (cd[1]) the chunk as it is, else cd[2] elements of the type
    whose parameters follow."""
    if len(cd) < 5 or cd[0] != len(cd):
        raise HDF5FormatError(f"{where}: N-bit parameters {list(cd)}")
    if cd[1]:
        return data
    n = _size(cd[2] * cd[4], expect, where)
    out = np.empty(n, np.uint8)
    rc = native().dsp_nbit_decode(data, len(data), _u32(cd), len(cd), out, n)
    if rc:
        raise HDF5FormatError(f"{where}: N-bit chunk " + (
            "shorter than its elements" if rc == -1 else
            f"with bad parameters {list(cd)}"))
    return out.tobytes()


def scaleoffset(data: bytes, cd, expect: int, where: str) -> bytes:
    """A scale-offset chunk (H5Z__filter_scaleoffset): integers at
    their minimum bits, or floats by D-scale; E-scale, which HDF5 does
    not write, is refused by name."""
    if len(cd) < 8:
        raise HDF5FormatError(f"{where}: scale-offset parameters "
                              f"{list(cd)}")
    if cd[3] == 1 and cd[0] == 1:
        raise UnsupportedFeature("scale-offset E-scale (filter 6)")
    n = _size(cd[2] * cd[4], expect, where)
    out = np.empty(n, np.uint8)
    rc = native().dsp_scaleoffset_decode(data, len(data), _u32(cd), len(cd),
                                       out, n)
    if rc:
        raise HDF5FormatError(f"{where}: scale-offset chunk " + (
            "shorter than its elements" if rc == -1 else
            f"with bad parameters {list(cd)}"))
    return out.tobytes()


def szip(data: bytes, cd, expect: int, where: str) -> bytes:
    """An szip chunk (H5Z__filter_szip): the decoded size as a
    little-endian uint32, then the CCSDS 121.0 stream of libaec's SZ
    interface under cd's option mask, pixels per block, bits per pixel
    and pixels per scanline."""
    if len(cd) < 4 or len(data) < 4:
        raise HDF5FormatError(f"{where}: szip parameters {list(cd)} or "
                              "chunk too short")
    n = _size(int.from_bytes(data[:4], "little"), expect, where)
    out = np.empty(n, np.uint8)
    body = data[4:]
    rc = native().dsp_szip_decode(body, len(body), cd[0], cd[1], cd[2], cd[3],
                                out, n)
    if rc:
        raise HDF5FormatError(f"{where}: szip chunk " + {
            -1: "shorter than its samples", -2: f"with bad parameters "
            f"{list(cd)}"}.get(rc, "malformed"))
    return out.tobytes()


#: filter id -> decoder(data, client data values, expected size, where)
DECODERS = {32000: lzf, 5: nbit, 6: scaleoffset, 4: szip}
