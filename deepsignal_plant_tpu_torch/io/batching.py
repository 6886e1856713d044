"""Host-side feed (copy of deepsignal_plant_tpu/io/batching.py:28-38 and
:264-367): stream feature lines in blocks, parse ahead of the device in a
bounded prefetch thread, and write output rows on a background thread.

The JAX package pads every block to one static ``device_batch`` shape
because XLA compiles per shape. PyTorch runs eagerly and the layer
kernel masks a ragged batch edge itself, so the port sends each block
as it is.
"""
from __future__ import annotations

import gzip
import queue
import threading
from typing import Iterable, Iterator

from ..utils.formats import gzip_path, open_text

_SENTINEL = object()


def iter_line_blocks(path: str, block_lines: int) -> Iterator[list[str]]:
    """Yield blocks of raw lines from a (possibly gzipped) features file."""
    with open_text(path) as rf:
        block: list[str] = []
        for line in rf:
            block.append(line)
            if len(block) >= block_lines:
                yield block
                block = []
        if block:
            yield block


class PrefetchIterator:
    """Run an iterator in a daemon thread with a bounded queue: the producer
    (TSV parsing) overlaps the consumer (device compute + writing)."""

    def __init__(self, it: Iterable, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def _run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as exc:  # propagated to the consumer
                self._err = exc
            finally:
                self._q.put(_SENTINEL)

        self._t = threading.Thread(target=_run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class AsyncWriter:
    """Bounded background writer thread (text rows -> file), replacing the
    reference's writer process (call_modifications.py:262-282)."""

    def __init__(self, path: str, is_gzip: bool = False, depth: int = 64):
        self.path = gzip_path(path) if is_gzip else path
        self._fh = gzip.open(self.path, "wb") if is_gzip else open(
            self.path, "wb")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            while True:
                rows = self._q.get()
                if rows is _SENTINEL:
                    break
                self._fh.write("\n".join(rows).encode())
                self._fh.write(b"\n")
        except BaseException as exc:
            self._err = exc
            # keep draining so producers blocked on a full queue (and
            # close()'s sentinel put) never hang; the error surfaces on
            # the producer's next write_rows/close call
            while self._q.get() is not _SENTINEL:
                pass
        finally:
            self._fh.close()

    def write_rows(self, rows: list[str]):
        if self._err is not None:
            raise self._err
        if rows:
            self._q.put(rows)

    def close(self):
        self._q.put(_SENTINEL)
        self._t.join()
        if self._err is not None:
            raise self._err
