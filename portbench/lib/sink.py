"""The program's call rows, read from a named pipe as it writes them.

A cell's rows would be gigabytes a run on disk; the program writes them
to a FIFO in the run's work directory instead. Each pass opens the
pipe, writes, and closes it; the reader sees the close as the pass's
end (``wait_pass``) and keeps of each pass what the comparison needs:
its row count, whether its last row ends, and the sampled rows' bytes.

The reader is a child process (``python3 -m portbench.lib.sink``, numpy
only), not a thread: a reading thread would take the interpreter lock
from the program's threads for every chunk, and the program's writer
would wait on it. Inside the child one thread reads each pass into a
buffer and reopens the pipe at once, and a second finds the finished
pass's rows while the next pass runs. A pass of no bytes is the stop.
"""
from __future__ import annotations

import errno
import fcntl
import json
import os
import queue
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np

PIPE_BYTES = 1 << 20
WAIT_S = 120.0


@dataclass
class PassRows:
    rows: int                # newline-terminated rows
    ragged: bool             # bytes after the last newline
    index: np.ndarray        # sampled row numbers present in the pass
    lines: list              # their bytes, without the newline


class RowSink:
    """The parent's side: starts the reader, waits for each pass's end,
    and collects the passes."""

    def __init__(self, workdir: str, index: np.ndarray, expect_bytes: int):
        self.path = os.path.join(workdir, "calls.fifo")
        self._result = os.path.join(workdir, "calls.json")
        os.mkfifo(self.path)
        idx = os.path.join(workdir, "sample_index.npy")
        np.save(idx, index)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.lib.sink", self.path, idx,
             str(int(expect_bytes)), self._result],
            cwd=root, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE)

    def wait_pass(self) -> int:
        """The bytes of the pass whose writer has closed the pipe."""
        line = self._proc.stdout.readline()
        if not line:
            raise RuntimeError("the call rows' reader ended "
                               f"(exit {self._proc.wait(WAIT_S)})")
        return int(line)

    def close(self) -> list[PassRows]:
        """Stop the reader once every pass is scanned; the passes."""
        deadline = time.monotonic() + WAIT_S
        while self._proc.poll() is None and time.monotonic() < deadline:
            try:
                # an empty pass: a writer that opens and closes
                os.close(os.open(self.path, os.O_WRONLY | os.O_NONBLOCK))
                break
            except OSError as exc:
                if exc.errno != errno.ENXIO:   # the reader is not open yet
                    raise
                time.sleep(0.01)
        try:
            rc = self._proc.wait(WAIT_S)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
            raise RuntimeError("the call rows' reader did not stop") \
                from None
        finally:
            self._proc.stdout.close()
        if rc != 0:
            raise RuntimeError(f"the call rows' reader failed (exit {rc})")
        with open(self._result) as fh:
            data = json.load(fh)
        return [PassRows(p["rows"], p["ragged"], np.array(p["index"],
                                                          np.int64),
                         [s.encode("latin-1") for s in p["lines"]])
                for p in data]


def _child(fifo: str, index_path: str, expect: int, result: str) -> None:
    index = np.load(index_path)
    free: queue.Queue = queue.Queue()
    work: queue.Queue = queue.Queue()
    for _ in range(2):
        free.put(bytearray(int(expect * 1.25) + (1 << 20)))
    passes: list = []

    def scan():
        while (item := work.get()) is not None:
            buf, n = item
            arr = np.frombuffer(buf, np.uint8, count=n)
            nl = np.flatnonzero(arr == 10)
            rows = len(nl)
            starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
            idx = index[index < rows]
            lines = [bytes(buf[s:e]).decode("latin-1") for s, e in
                     zip(starts[idx].tolist(), nl[idx].tolist())]
            ragged = n > 0 and (rows == 0 or int(nl[-1]) != n - 1)
            del arr
            passes.append({"rows": rows, "ragged": ragged,
                           "index": idx.tolist(), "lines": lines})
            free.put(buf)

    scanner = threading.Thread(target=scan)
    scanner.start()
    try:
        while True:
            fd = os.open(fifo, os.O_RDONLY)        # until a writer opens
            try:
                fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, PIPE_BYTES)
            except OSError:
                pass
            buf = free.get()
            n = 0
            with os.fdopen(fd, "rb", buffering=0) as fh:
                while True:
                    if n == len(buf):
                        buf = buf + bytearray(len(buf))
                    with memoryview(buf) as mv:
                        k = fh.readinto(mv[n:])
                    if not k:
                        break
                    n += k
            if n == 0:
                break
            work.put((buf, n))
            print(n, flush=True)
    finally:
        work.put(None)
        scanner.join()
    with open(result, "w") as fh:
        json.dump(passes, fh)


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
