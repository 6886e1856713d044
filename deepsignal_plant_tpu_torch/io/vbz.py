"""VBZ, the HDF5 filter 32020 that Oxford Nanopore's MinKNOW writes fast5
signals with (nanoporetech/vbz_compression, its ``vbz_plugin``), decoded
without the plugin: zstd through ctypes against the system's
``libzstd.so.1``, the Stream VByte layer in the port's native library
(``dsp_vbz_unpack`` in native/featparse.cpp).

A stored chunk is, as the plugin writes it (``vbz_compress_sized``):

- a ``uint32`` little-endian: the chunk's size before compression;
- the payload: a zstd frame when the filter's ``zstd_level`` is not 0,
  else the layer below as it is;
- below it, when ``integer_size`` is not 0, a Stream VByte stream over
  the chunk's integers (zig-zag deltas when ``delta_zig_zag`` is set);
  with an ``integer_size`` of 0 the chunk's bytes themselves.

The filter's client data values are ``(version, integer_size,
delta_zig_zag, zstd_level)``, missing ones 0; MinKNOW writes ``(0, 2, 1,
1)``. Version 0 is decoded. Other versions raise ``VBZPluginError``
naming the version: the port has no statement of their layout to hold a
decoder to. A malformed frame, a short stream or a size that disagrees
with the chunk header raises ``HDF5FormatError``; nothing returns a
partial or zero-filled chunk.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from .hdf5 import HDF5FormatError, VBZPluginError, native

ZSTD_LIBRARY = "libzstd.so.1"
_ZSTD_CONTENTSIZE_ERROR = (1 << 64) - 2
_ZSTD_CONTENTSIZE_UNKNOWN = (1 << 64) - 1

_lock = threading.Lock()
_zstd: dict[str, ctypes.CDLL] = {}


def libzstd() -> ctypes.CDLL:
    """The system's zstd library, loaded through the dynamic loader;
    raises VBZPluginError when it is missing."""
    with _lock:
        lib = _zstd.get(ZSTD_LIBRARY)
        if lib is None:
            try:
                lib = ctypes.CDLL(ZSTD_LIBRARY)
            except OSError as exc:
                raise VBZPluginError(
                    reason=f"{ZSTD_LIBRARY} did not load ({exc}); it was "
                    "looked for by the dynamic loader (LD_LIBRARY_PATH, "
                    "/etc/ld.so.cache, /lib and /usr/lib). Install the "
                    "system's zstd library (libzstd1 on Debian and "
                    "Ubuntu)") from None
            size_t, vp = ctypes.c_size_t, ctypes.c_void_p
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
            lib.ZSTD_decompress.restype = size_t
            lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getErrorName.argtypes = [size_t]
            lib.ZSTD_versionNumber.restype = ctypes.c_uint
            lib.ZSTD_versionNumber.argtypes = []
            _zstd[ZSTD_LIBRARY] = lib
        return lib


def zstd_decompress(data: bytes, limit: int, where: str = ""
                    ) -> np.ndarray:
    """The content of the zstd frame(s) in ``data`` (uint8), at most
    ``limit`` bytes."""
    lib = libzstd()
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise HDF5FormatError(f"{where}VBZ: no zstd frame")
    if size != _ZSTD_CONTENTSIZE_UNKNOWN:
        if size > limit:
            raise HDF5FormatError(f"{where}VBZ: a zstd frame of {size} "
                                  f"bytes where at most {limit} fit")
        limit = size
    out = np.empty(max(limit, 1), np.uint8)
    got = lib.ZSTD_decompress(out.ctypes.data, limit, data, len(data))
    if lib.ZSTD_isError(got):
        raise HDF5FormatError(f"{where}VBZ: zstd: "
                              f"{lib.ZSTD_getErrorName(got).decode()}")
    return out[:got]


def parameters(cd_values) -> tuple[int, int, bool, int]:
    """(version, integer_size, delta_zig_zag, zstd_level) of the filter's
    client data values, missing ones 0."""
    v = list(cd_values) + [0] * (4 - len(cd_values))
    return v[0], v[1], bool(v[2]), v[3]


def decode_chunk(data: bytes, cd_values, expect: int | None,
                 where: str = "") -> bytes:
    """The bytes of one stored VBZ chunk: ``expect`` of them (None: as
    many as its header says)."""
    version, isize, zigzag, level = parameters(cd_values)
    if version != 0:
        raise VBZPluginError(where, f"VBZ version {version} (client data "
                             f"values {list(cd_values)}) is not decoded: "
                             "the port decodes version 0")
    if isize not in (0, 1, 2, 4):
        raise HDF5FormatError(f"{where}VBZ integer size {isize}")
    if len(data) < 4:
        raise HDF5FormatError(f"{where}VBZ chunk of {len(data)} bytes")
    size = int.from_bytes(data[:4], "little")
    if expect is not None and size != expect:
        raise HDF5FormatError(f"{where}VBZ chunk header says {size} bytes, "
                              f"the chunk holds {expect}")
    if isize and size % isize:
        raise HDF5FormatError(f"{where}VBZ chunk of {size} bytes is no "
                              f"whole number of {isize}-byte integers")
    count = size // isize if isize else size
    # a Stream VByte stream of ``count`` values is at most this long
    stream_max = (count + 3) // 4 + 4 * count if isize else size
    body = data[4:]
    if level:
        body = zstd_decompress(body, stream_max, where)
    if not isize:
        if len(body) != size:
            raise HDF5FormatError(f"{where}VBZ chunk of {len(body)} bytes, "
                                  f"header says {size}")
        return bytes(body)
    out = np.empty(size, np.uint8)
    used = native().dsp_vbz_unpack(
        body.ctypes.data if level else body, len(body), count, isize,
        int(zigzag), out)
    if used != len(body):
        raise HDF5FormatError(
            f"{where}VBZ Stream VByte stream of {len(body)} bytes "
            + ("is short of its" if used < 0 else f"holds {used} bytes of")
            + f" {count} values")
    return out.tobytes()
