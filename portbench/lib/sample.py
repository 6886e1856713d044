"""The sites whose rows the comparison reads, drawn from the seed, and
what it needs of them: each row's expected leading columns and k-mer,
and the model inputs the plain reference is given."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import text
from .reads import BASES, ReadChunk, windows


@dataclass
class Sample:
    index: np.ndarray        # (K,) sorted site indices (row numbers)
    info: list               # (K,) bytes: the six leading columns
    kmer5: list              # (K,) bytes: the centre 5-mer
    kmer: np.ndarray         # (K, L) int64 base codes
    means: np.ndarray        # (K, L) float32
    stds: np.ndarray         # (K, L) float32
    lens: np.ndarray         # (K, L) float32
    signals: np.ndarray      # (K, L, S) float32


def draw(seed: int, sites: int, k: int) -> np.ndarray:
    """``k`` site indices from the seed (its own stream), the first and
    the last site always among them; every site when ``k`` >= sites."""
    if k >= sites:
        return np.arange(sites, dtype=np.int64)
    rng = np.random.default_rng([seed, 0x5A3])
    pick = rng.choice(sites, size=k - 2, replace=False)
    return np.unique(np.concatenate([[0, sites - 1], pick])).astype(np.int64)


class Collector:
    """Keeps the sampled sites' rows and inputs as the chunks go by.
    ``wire``: the dtype in which the program receives the values
    (float32 for text, float16 for the v3 containers)."""

    def __init__(self, index: np.ndarray, kmer_len: int, wire):
        self.index = index
        self.L = kmer_len
        self.wire = np.dtype(wire)
        self.parts: list = []

    def add(self, chunk: ReadChunk) -> None:
        lo = np.searchsorted(self.index, chunk.site0)
        hi = np.searchsorted(self.index, chunk.site0 + chunk.n)
        local = self.index[lo:hi] - chunk.site0
        if not len(local):
            return
        blob, lens = text.join(text.info_parts(chunk, local))
        ends = np.cumsum(lens)
        info = [blob[e - n:e] for e, n in zip(ends.tolist(), lens.tolist())]
        win = windows(chunk, local, self.L)
        codes = chunk.codes[win].astype(np.int64)
        c = self.L // 2
        kmer5 = [bytes(BASES[r]) for r in codes[:, c - 2:c + 3]]

        def value(q):
            return (q / 1e6).astype(self.wire).astype(np.float32)
        self.parts.append((info, kmer5, codes, value(chunk.means[win]),
                           value(chunk.stds[win]),
                           chunk.lens[win].astype(self.wire).astype(
                               np.float32),
                           value(chunk.rect[win])))

    def finish(self) -> Sample:
        info = [s for p in self.parts for s in p[0]]
        kmer5 = [s for p in self.parts for s in p[1]]
        arrays = [np.concatenate([p[i] for p in self.parts])
                  for i in range(2, 7)]
        if len(info) != len(self.index):
            raise RuntimeError(f"{len(info)} sampled sites of "
                               f"{len(self.index)}")
        return Sample(self.index, info, kmer5, *arrays)


@dataclass
class Input:
    """A traffic kind's input on disk."""
    path: str                # the file or directory the entry reads
    sites: int               # rows a pass emits
    bytes_written: int
    sample: Sample
