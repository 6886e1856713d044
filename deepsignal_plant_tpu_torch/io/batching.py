"""Host-side feed (copy of deepsignal_plant_tpu/io/batching.py:41-60,
:117-122, :163-367): stream newline-aligned byte blocks, parse ahead of the device in worker threads (the native parser
releases the GIL), re-chunk parsed blocks into device batches, and write
output rows on a background thread.

The JAX package pads every batch to one static ``device_batch`` shape
because XLA compiles per shape. PyTorch runs eagerly and the layer
kernel masks a ragged batch edge itself, so the port sends the last
batch as it is.
"""
from __future__ import annotations

import gzip
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import chain
from typing import Callable, Iterable, Iterator

import numpy as np

from ..utils.fastparse import parse_feature_bytes
from ..utils.formats import FeatureBatch, gzip_path

_SENTINEL = object()


def iter_byte_blocks(path: str, block_bytes: int = 8 << 20
                     ) -> Iterator[bytes]:
    """Yield newline-aligned byte blocks of a (possibly gzipped) file, for
    the native parser."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as rf:
        carry = b""
        while True:
            chunk = rf.read(block_bytes)
            if not chunk:
                if carry:
                    yield carry
                return
            chunk = carry + chunk
            cut = chunk.rfind(b"\n")
            if cut == -1:
                carry = chunk
                continue
            yield chunk[:cut + 1]
            carry = chunk[cut + 1:]


def default_parse_workers() -> int:
    """Parser threads: all cores up to 4 (the native parse releases the
    GIL; beyond ~4 threads the main thread's batching and formatting
    bind)."""
    return max(2, min(4, os.cpu_count() or 2))


def bounded_thread_map(fn: Callable, it: Iterable, workers: int = 2,
                       depth: int = 4) -> Iterator:
    """Ordered parallel map over an iterator with bounded lookahead:
    ThreadPoolExecutor.map without its unbounded input consumption."""
    it = iter(it)
    pool = ThreadPoolExecutor(max_workers=workers)
    window: deque = deque()
    try:
        exhausted = False
        while True:
            while not exhausted and len(window) < depth:
                try:
                    window.append(pool.submit(fn, next(it)))
                except StopIteration:
                    exhausted = True
            if not window:
                break
            yield window.popleft().result()
    finally:
        # cancel what has not started; wait for the blocks in progress,
        # so no worker outlives the generator
        pool.shutdown(wait=True, cancel_futures=True)


def _merge(batches: list[FeatureBatch]) -> FeatureBatch:
    if len(batches) == 1:
        return batches[0]
    return FeatureBatch(
        sampleinfo=list(chain.from_iterable(b.sampleinfo for b in batches)),
        kmer=np.concatenate([b.kmer for b in batches]),
        base_means=np.concatenate([b.base_means for b in batches]),
        base_stds=np.concatenate([b.base_stds for b in batches]),
        base_signal_lens=np.concatenate(
            [b.base_signal_lens for b in batches]),
        signals=np.concatenate([b.signals for b in batches]),
        labels=np.concatenate([b.labels for b in batches]))


def _split(fb: FeatureBatch, n: int) -> tuple[FeatureBatch, FeatureBatch]:
    """Split into (first n rows, rest); array parts are views, not copies."""
    head = FeatureBatch(fb.sampleinfo[:n], fb.kmer[:n], fb.base_means[:n],
                        fb.base_stds[:n], fb.base_signal_lens[:n],
                        fb.signals[:n], fb.labels[:n])
    tail = FeatureBatch(fb.sampleinfo[n:], fb.kmer[n:], fb.base_means[n:],
                        fb.base_stds[n:], fb.base_signal_lens[n:],
                        fb.signals[n:], fb.labels[n:])
    return head, tail


class BatchAssembler:
    """Re-chunk a stream of ragged FeatureBatches into exact ``target``-row
    batches with one array copy per emitted batch (fragments are views)."""

    def __init__(self, target: int):
        self.target = target
        self._frags: deque = deque()
        self._rows = 0

    def add(self, fb: FeatureBatch) -> None:
        if len(fb):
            self._frags.append(fb)
            self._rows += len(fb)

    def pop_full(self) -> FeatureBatch | None:
        if self._rows < self.target:
            return None
        pieces: list[FeatureBatch] = []
        need = self.target
        while need > 0:
            fb = self._frags.popleft()
            if len(fb) <= need:
                pieces.append(fb)
                need -= len(fb)
            else:
                head, tail = _split(fb, need)
                pieces.append(head)
                self._frags.appendleft(tail)
                need = 0
        self._rows -= self.target
        return _merge(pieces)

    def pop_rest(self) -> FeatureBatch | None:
        if self._rows == 0:
            return None
        pieces = list(self._frags)
        self._frags.clear()
        self._rows = 0
        return _merge(pieces)


def batches_from_features_file(path: str, device_batch: int,
                               kmer_len: int = 13, signal_len: int = 16,
                               parse_workers: int | None = None,
                               out_dtype: str = "float32",
                               ) -> Iterator[FeatureBatch]:
    """Parse a features TSV natively in ``parse_workers`` threads into
    FeatureBatches of exactly ``device_batch`` rows, the last one ragged
    (not padded)."""
    w = parse_workers or default_parse_workers()
    blocks = bounded_thread_map(
        lambda raw: parse_feature_bytes(raw, kmer_len, signal_len,
                                        out_dtype=out_dtype),
        iter_byte_blocks(path, 4 << 20), workers=w, depth=2 * w)
    asm = BatchAssembler(device_batch)
    try:
        for fb in blocks:
            asm.add(fb)
            while (full := asm.pop_full()) is not None:
                yield full
    finally:
        blocks.close()
    rest = asm.pop_rest()
    if rest is not None:
        yield rest


class PrefetchIterator:
    """Run an iterator in a daemon thread with a bounded queue: the producer
    (TSV parsing) overlaps the consumer (device compute + writing). A
    consumer that stops early calls ``close``."""

    def __init__(self, it: Iterable, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def _run():
            try:
                for item in it:
                    if self._stop.is_set():
                        break
                    self._q.put(item)
            except BaseException as exc:  # propagated to the consumer
                self._err = exc
            finally:
                close = getattr(it, "close", None)
                if close is not None:     # a generator's own clean-up
                    close()
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

    def close(self) -> None:
        """Stop the producer, close its iterator and join its thread;
        items not yet consumed are dropped."""
        self._stop.set()
        while self._t.is_alive():
            try:                  # unblock a put on the full queue
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._t.join()


class AsyncWriter:
    """Bounded background writer thread (byte blocks -> file), replacing
    the reference's writer process (call_modifications.py:262-282)."""

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
                block = self._q.get()
                if block is _SENTINEL:
                    break
                self._fh.write(block)
        except BaseException as exc:
            self._err = exc
            # keep draining so producers blocked on a full queue (and
            # close()'s sentinel put) never hang; the error surfaces on
            # the producer's next write/close call
            while self._q.get() is not _SENTINEL:
                pass
        finally:
            self._fh.close()

    def write(self, block: bytes):
        """Queue a newline-terminated block of rows."""
        if self._err is not None:
            raise self._err
        if block:
            self._q.put(block)

    def close(self):
        self._q.put(_SENTINEL)
        self._t.join()
        if self._err is not None:
            raise self._err
