"""The JAX package's native library (deepsignal_plant_tpu/native/
libdsp_native.so), loaded safely from the port's tests under pytest-xdist.

The library is git-ignored, so a fresh tree builds it at first use, and
every build writes the same ``libdsp_native.so.tmp``: workers that build
at once (each collects every test file) can break each other's build,
and a process whose first load failed keeps ``None`` for its whole life.
``jax_native_lib`` loads the library under a cross-process ``fcntl`` lock
on a file beside it, so one process builds at a time, and where this
process's loader cached ``None`` although the library is there (or a
load fails while another process's unlocked build still runs) it clears
the loader's cache and loads again. The JAX package is not changed.
"""
from __future__ import annotations

import fcntl
import os
import time

from deepsignal_plant_tpu import native as jax_native

LOCK_PATH = jax_native._SO_PATH + ".lock"
ATTEMPTS = 5
RETRY_SECONDS = 3.0


def _load_again():
    jax_native._tried = False
    jax_native._lib = None
    return jax_native.get_native_lib()


def jax_native_lib():
    """The JAX package's native library (a ctypes handle), or None where
    it does not build here; loaded as described above. A test module
    calls it where it is imported, so every worker loads the library
    during collection, before any test runs."""
    lib = jax_native._lib
    if lib is not None:
        return lib
    with open(LOCK_PATH, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            lib = jax_native.get_native_lib()
            for attempt in range(ATTEMPTS):
                if lib is not None:
                    break
                # an unlocked build (a JAX test module's own first load in
                # another worker) may still be writing the library; from
                # the third attempt on, build it again here
                if attempt:
                    time.sleep(RETRY_SECONDS)
                if attempt >= 2:
                    jax_native.build_native(force=True)
                lib = _load_again()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return lib
