"""Build the CUDA sources under ``csrc/`` at first use and load them with
ctypes.

Each ``csrc/<name>.cu`` compiles on its own, with a plain C interface
and no PyTorch headers (seconds, not minutes), into
``build/kernels/<name>-<hash>.so`` beside the package. The hash covers
the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source rebuilds and an unchanged one loads what an earlier
process built. A failed build raises with the compiler's output.
``keyed_library`` and ``compile_library`` also build the host library
of ``native/`` (with g++).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def keyed_library(build_dir: Path, name: str, inputs: list[Path],
                  flags: list[str]) -> Path:
    """``build_dir/<name>-<hash>.so``, the hash over the inputs' bytes and
    the flags."""
    h = hashlib.sha256()
    for path in inputs:
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir / f"{name}-{h.hexdigest()[:16]}.so"


def compile_library(out: Path, cmd: list[str], what: str) -> Path:
    """Run ``cmd -o <tmp>`` and move the result to ``out``, unless ``out``
    exists. The compiler's report is kept in <out>.log; a failed build
    raises with it."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [*cmd, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:           # the compiler is not there
        os.unlink(tmp)
        raise RuntimeError(f"{what}: cannot run {cmd[0]} ({exc})") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("{} failed ({}):\n{}{}".format(
            what, " ".join(cmd), proc.stdout, proc.stderr))
    Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)      # atomic: a concurrent build loads either
    return out


def library_path(name: str) -> Path:
    """The library's path, keyed by csrc/<name>.cu, the shared headers
    (csrc/*.cuh) and the flags."""
    return keyed_library(BUILD_DIR, name,
                         [CSRC_DIR / f"{name}.cu",
                          *sorted(CSRC_DIR.glob("*.cuh"))], NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library exists. The compiler's
    report (registers, shared memory, spills) is kept in <lib>.log."""
    return compile_library(
        library_path(name),
        [nvcc_path(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu")],
        f"nvcc build of {name}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built if needed. Every source
    exports ``const char* dsp_cuda_error_string(int)``."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            lib.dsp_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dsp_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        msg = lib.dsp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
