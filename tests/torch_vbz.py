"""A VBZ encoder (HDF5 filter 32020, nanoporetech/vbz_compression) for
test fixtures: numpy for the delta, zig-zag and Stream VByte layers, the
system's ``libzstd.so.1`` through ctypes for zstd. It shares no code
with the port's decoder (deepsignal_plant_tpu_torch/io/vbz.py and
``dsp_vbz_unpack``), so each is held to the other and to hand-worked
vectors. The port writes no VBZ itself; chip_smoke.py imports this
module to make VBZ twins of its fast5 run on a machine without h5py.

A chunk, as ONT's plugin writes it: a uint32 little-endian size of the
raw chunk, then the payload, a zstd frame of the Stream VByte stream
(no zstd layer at level 0). ``MINKNOW`` are the client data values
MinKNOW writes: version 0, 2-byte integers, delta zig-zag, zstd level
1.
"""
from __future__ import annotations

import ctypes

import numpy as np

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


def _libzstd():
    lib = ctypes.CDLL("libzstd.so.1")
    size_t = ctypes.c_size_t
    lib.ZSTD_compressBound.restype = size_t
    lib.ZSTD_compressBound.argtypes = [size_t]
    lib.ZSTD_compress.restype = size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, size_t, ctypes.c_void_p,
                                  size_t, ctypes.c_int]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [size_t]
    return lib


def zstd_compress(data: bytes, level: int) -> bytes:
    lib = _libzstd()
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(out, cap, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise RuntimeError("ZSTD_compress failed")
    return out.raw[:n]


def vbz_encode(raw: bytes, cd_values=MINKNOW) -> bytes:
    """One stored chunk of ``raw``, the chunk's bytes."""
    version, isize, zigzag, level = (list(cd_values) + [0] * 4)[:4]
    assert version == 0 and isize in (0, 1, 2, 4)
    if isize:
        vals = np.frombuffer(raw, f"<i{isize}")
        words = zigzag_delta(vals) if zigzag else \
            vals.astype(np.int64).astype(np.uint32)
        body = streamvbyte_encode(words)
    else:
        body = bytes(raw)
    if level:
        body = zstd_compress(body, level)
    return len(raw).to_bytes(4, "little") + body


def chunk_encoder(cd_values=MINKNOW):
    """``encode`` of the port writer's hdf5.Chunked: a chunk's array to
    its stored VBZ bytes."""
    return lambda chunk: vbz_encode(np.ascontiguousarray(chunk).tobytes(),
                                    cd_values)
