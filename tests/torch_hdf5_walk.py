"""Walk a whole HDF5 file with the port's reader, and the mutation
harness of the port's HDF5 tests: mutated files each read whole or raise
a Python exception of the reader's within a time limit. A helper
module, not a test module: the spawned child imports it, and with it
only numpy and the port's reader."""
from __future__ import annotations

import multiprocessing as mp
import os
import queue

import numpy as np

from deepsignal_plant_tpu_torch.io import hdf5

#: what a walk of a mutated file may end in besides reading it whole:
#: the reader's refusal, or a link that a mutation left dangling
OUTCOMES = ("read", "HDF5FormatError", "KeyError")


def walk_file(path: str) -> int:
    """Every attribute value, every dataset and every link target of a
    file, read with the port's reader (links that dangle skipped); the
    number of objects read."""
    seen: set = set()
    with hdf5.File(path) as f:
        stack = [f.root]
        while stack:
            obj = stack.pop()
            key = (id(obj.file), obj.addr)
            if key in seen:
                continue
            seen.add(key)
            dict(obj.attrs)
            if isinstance(obj, hdf5.Dataset):
                obj.read()
            elif isinstance(obj, hdf5.Group):
                for k in obj.keys():
                    try:
                        stack.append(obj[k])
                    except KeyError:
                        pass
    return len(seen)


def _walk_mutants(paths, q):
    """Child process: walk each file, report (path, outcome) as it ends;
    None after the last."""
    for p in paths:
        try:
            walk_file(p)
            q.put((p, "read"))
        except hdf5.HDF5FormatError:
            q.put((p, "HDF5FormatError"))
        except KeyError:
            q.put((p, "KeyError"))
        except Exception as exc:  # noqa: BLE001 - reported as a failure
            q.put((p, f"{type(exc).__name__}: {exc}"))
    q.put(None)


def mutants(src: str, out_dir: str, n: int, seed: int) -> list[str]:
    """``n`` copies of ``src`` with 1-3 random bytes changed, every
    tenth also truncated."""
    data = bytes(open(src, "rb").read())
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        m = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
        if i % 10 == 9:
            m = m[:int(rng.integers(8, len(m)))]
        p = os.path.join(out_dir, f"m{i}.h5")
        with open(p, "wb") as fh:
            fh.write(m)
        paths.append(p)
    return paths


def walk_mutants(paths: list[str]) -> dict:
    """basename -> outcome of each file, walked in turn by one spawned
    child that reports each as it ends; a hang or a crash raises
    AssertionError naming the file."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_walk_mutants, args=(paths, q))
    proc.start()
    outcomes = {}
    try:
        for i, p in enumerate(paths):
            try:
                got = q.get(timeout=60 if i == 0 else 10)
            except queue.Empty:
                raise AssertionError(f"{os.path.basename(p)} hung or crashed "
                                     f"the reader (exit code {proc.exitcode})"
                                     ) from None
            assert got[0] == p
            outcomes[os.path.basename(p)] = got[1]
        assert q.get(timeout=10) is None
        proc.join(10)
        assert not proc.is_alive() and proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
    return outcomes
