"""The host library of the features-TSV plane (native/featparse.cpp),
built with g++ at first use and loaded with ctypes.

The library goes to ``build/native/featparse-<hash>.so`` beside the
package, the hash over the source, the compiler and its flags, so an
edited source rebuilds and an unchanged one loads what an earlier process
built. The flags leave out ``-march=native``: one source gives the same
bytes on every x86-64 host. There is no fallback: a failed build raises
with the compiler's output, and no path parses in Python instead.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..ops._build import PACKAGE_DIR, compile_library, keyed_library

SOURCE = Path(__file__).resolve().parent / "featparse.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
CXX = "g++"
# -ffp-contract=off: no FMA contraction, so the parser's float arithmetic
# is the same on every host and matches the JAX package's library
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    return keyed_library(BUILD_DIR, "featparse", [SOURCE],
                         [CXX, *CXX_FLAGS])


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every function the package calls."""
    c_char_p, i64, i32 = ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32

    def arr(dt):
        return np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")

    i8p, u8p, u16p = arr(np.int8), arr(np.uint8), arr(np.uint16)
    i32p, i64p, f32p = arr(np.int32), arr(np.int64), arr(np.float32)
    for name, restype, argtypes in (
            ("dsp_count_lines", i64, [c_char_p, i64]),
            ("dsp_parse_features", i64,
             [c_char_p, i64, i32, i32, i32p, f32p, f32p, f32p, f32p, i32p,
              i64p, i64p]),
            ("dsp_parse_features_f16", i64,
             [c_char_p, i64, i32, i32, i8p, u16p, u16p, u16p, u16p, i32p,
              i64p, i64p]),
            ("dsp_emit_call_rows", i64,
             [c_char_p, i64p, i64p, f32p, i8p, i64, i32, u8p]),
            ("dsp_format_call_suffixes", i64,
             [f32p, i32p, i64, i32, u8p, i32p]),
            ("dsp_pack_rows", i64,
             [c_char_p, i64p, i64p, i8p, u16p, u16p, u16p, u16p, i64, i32,
              i32, i8p, u16p, u16p, u16p, u16p, i32p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def load() -> ctypes.CDLL:
    """The loaded library, built if needed; raises if g++ fails."""
    out = library_path()
    with _lock:
        if out not in _libs:
            compile_library(out, [CXX, *CXX_FLAGS, str(SOURCE)],
                            f"{CXX} build of {SOURCE.name}")
            lib = ctypes.CDLL(str(out))
            _declare(lib)
            _libs[out] = lib
        return _libs[out]
