"""A frozen copy of the VBZ encoder the program's tests use
(tests/torch_vbz.py as of this benchmark's fast5 cell): HDF5 filter 32020
of nanoporetech/vbz_compression, numpy for the delta, zig-zag and Stream
VByte layers, the system's ``libzstd.so.1`` through ctypes for zstd. It
shares no code with the program's decoder, and the benchmark keeps its
own copy so that no later change to the program or its tests can change
the input.

A chunk, as ONT's plugin writes it: a uint32 little-endian size of the
raw chunk, then a zstd frame of the Stream VByte stream. ``MINKNOW`` are
the client data values MinKNOW writes: version 0, 2-byte integers, delta
zig-zag, zstd level 1.
"""
from __future__ import annotations

import ctypes

import numpy as np

FILTER_ID = 32020
MINKNOW = (0, 2, 1, 1)


def zigzag_delta(values: np.ndarray) -> np.ndarray:
    """uint32 zig-zag codes of the deltas of ``values`` widened to 32
    bits (signed types sign-extend), the first delta from 0."""
    v = np.asarray(values).astype(np.int64).astype(np.uint32).astype(
        np.int64)
    d = np.diff(v, prepend=0).astype(np.uint32).view(np.int32)
    d = d.astype(np.int64)
    return ((d << 1) ^ (d >> 31)).astype(np.uint32)


def streamvbyte_encode(words: np.ndarray) -> bytes:
    """Classic Stream VByte: ceil(n/4) control bytes (2 bits a value,
    the first of four in the low bits, key k = k+1 bytes), then each
    value's k+1 low bytes, little-endian."""
    w = np.asarray(words, np.uint32)
    n = len(w)
    nb = (1 + (w > 0xFF) + (w > 0xFFFF) + (w > 0xFFFFFF)).astype(np.int64)
    keys = np.zeros(-(-n // 4) * 4, np.uint8)
    keys[:n] = nb - 1
    ctrl = (keys.reshape(-1, 4) << np.array([0, 2, 4, 6], np.uint8)).sum(
        1).astype(np.uint8)
    le = w.astype("<u4").view(np.uint8).reshape(n, 4)
    data = le[np.arange(4)[None, :] < nb[:, None]]
    return ctrl.tobytes() + data.tobytes()


class _Zstd:
    """libzstd's one-shot compressor, loaded once."""

    def __init__(self):
        lib = ctypes.CDLL("libzstd.so.1")
        size_t = ctypes.c_size_t
        lib.ZSTD_compressBound.restype = size_t
        lib.ZSTD_compressBound.argtypes = [size_t]
        lib.ZSTD_compress.restype = size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, size_t,
                                      ctypes.c_void_p, size_t, ctypes.c_int]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [size_t]
        self.lib = lib

    def compress(self, data: bytes, level: int) -> bytes:
        cap = self.lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = self.lib.ZSTD_compress(out, cap, data, len(data), level)
        if self.lib.ZSTD_isError(n):
            raise RuntimeError("ZSTD_compress failed")
        return out.raw[:n]


def chunk_encoder(cd_values=MINKNOW):
    """A chunk's int array to its stored VBZ bytes (``Chunked.encode``
    of lib/hdf5w.py)."""
    version, isize, zigzag, level = (list(cd_values) + [0] * 4)[:4]
    if version != 0 or isize not in (1, 2, 4):
        raise ValueError(f"VBZ client data {cd_values} not written here")
    zstd = _Zstd() if level else None

    def encode(chunk: np.ndarray) -> bytes:
        raw = np.ascontiguousarray(chunk).tobytes()
        vals = np.frombuffer(raw, f"<i{isize}")
        words = zigzag_delta(vals) if zigzag else \
            vals.astype(np.int64).astype(np.uint32)
        body = streamvbyte_encode(words)
        if zstd is not None:
            body = zstd.compress(body, level)
        return len(raw).to_bytes(4, "little") + body
    return encode
