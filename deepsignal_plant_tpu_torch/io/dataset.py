"""Training datasets (counterpart of deepsignal_plant_tpu/io/dataset.py).

``FeatureDataset`` reads a features TSV, or v1 .npz feature batches,
once into dense host arrays. A TSV is parsed a single time by the native
parser at float32 (utils/fastparse.parse_feature_bytes, the same arrays
as the plain utils/formats.parse_feature_lines; labels are column 12);
an .npz file or a directory of them loads through
utils/formats.load_feature_npz (v1 only: a wire container raises).
Epochs are permutations of an index vector and batches are gathers.

``StreamingFeatureDataset`` holds one block of rows at a time: an epoch
visits the blocks in a shuffled order and each block's rows in a
shuffled order, with the JAX package's draws, so both packages give the
same batches in the same order from the same generator.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..models.bilstm import Batch
from ..utils.fastparse import parse_feature_bytes
from ..utils.formats import feature_npz_paths, load_feature_npz
from .batching import iter_byte_blocks


@dataclass
class FeatureDataset:
    kmer: np.ndarray              # (N, L) int32
    base_means: np.ndarray        # (N, L) f32
    base_stds: np.ndarray         # (N, L) f32
    base_signal_lens: np.ndarray  # (N, L) f32
    signals: np.ndarray           # (N, L, S) f32
    labels: np.ndarray            # (N,) int32

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in (self.kmer, self.base_means,
                                      self.base_stds, self.base_signal_lens,
                                      self.signals, self.labels))

    @classmethod
    def from_file(cls, path: str, kmer_len: int = 13, signal_len: int = 16,
                  block_bytes: int = 64 << 20) -> "FeatureDataset":
        """Read a features TSV (plain or .gz), a v1 .npz file or a
        directory of v1 .npz batches into one dataset."""
        npz_files = feature_npz_paths(path)
        if npz_files is not None:
            parts = [load_feature_npz(f) for f in npz_files]
        else:
            parts = [parse_feature_bytes(block, kmer_len, signal_len)
                     for block in iter_byte_blocks(path, block_bytes)]
        parts = [p for p in parts if len(p)]
        if not parts:
            z = np.zeros
            return cls(z((0, kmer_len), np.int32),
                       z((0, kmer_len), np.float32),
                       z((0, kmer_len), np.float32),
                       z((0, kmer_len), np.float32),
                       z((0, kmer_len, signal_len), np.float32),
                       z((0,), np.int32))
        return cls.concat(parts)

    @classmethod
    def concat(cls, parts: list) -> "FeatureDataset":
        """The rows of ``parts`` (datasets or FeatureBatches), in order."""
        return cls(
            kmer=np.concatenate([p.kmer for p in parts]),
            base_means=np.concatenate([p.base_means for p in parts]),
            base_stds=np.concatenate([p.base_stds for p in parts]),
            base_signal_lens=np.concatenate(
                [p.base_signal_lens for p in parts]),
            signals=np.concatenate([p.signals for p in parts]),
            labels=np.concatenate([p.labels for p in parts]))

    def take(self, idx) -> "FeatureDataset":
        """The dataset of rows ``idx``."""
        return FeatureDataset(self.kmer[idx], self.base_means[idx],
                              self.base_stds[idx],
                              self.base_signal_lens[idx],
                              self.signals[idx], self.labels[idx])

    def batch_at(self, idx) -> tuple[Batch, np.ndarray]:
        """(Batch of numpy arrays, labels) of rows ``idx`` (an index
        array or a slice)."""
        return (Batch(self.kmer[idx], self.base_means[idx],
                      self.base_stds[idx], self.base_signal_lens[idx],
                      self.signals[idx]),
                self.labels[idx])

    def iter_batches(self, batch_size: int, shuffle: bool,
                     rng: np.random.Generator | None = None,
                     pad_to_batch: bool = False,
                     ) -> Iterator[tuple[Batch, np.ndarray, int]]:
        """Yield (batch, labels, n_valid). With ``pad_to_batch`` every
        batch has ``batch_size`` rows, the tail padded with row 0 (a
        multi-rank run's host-fed plane masks it)."""
        n = len(self)
        order = (rng or np.random.default_rng()).permutation(n) \
            if shuffle else np.arange(n)
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            n_valid = len(idx)
            if n_valid < batch_size and pad_to_batch:
                pad = np.zeros(batch_size - n_valid, dtype=idx.dtype)
                idx = np.concatenate([idx, pad])
            batch, labels = self.batch_at(idx)
            yield batch, labels, n_valid


class StreamingFeatureDataset:
    """Bounded-memory training dataset over a big features TSV (plain or
    .gz) or a directory of v1 .npz batches (JAX io/dataset.py:100-221).

    A TSV is cut into blocks of ``block_rows`` lines, whose byte offsets
    one pass records; an .npz file is a block. An epoch draws the block
    order (one ``rng.permutation``; a .gz file keeps its order, since a
    backward seek re-inflates the whole prefix), then per block the
    order of its rows together with the rows the previous block left
    over (one ``rng.permutation`` each), and yields full batches; the
    rows that do not fill a batch carry into the next block, and the
    last ones form the epoch's tail batch. Blocks parse with the native
    parser.
    """

    def __init__(self, path: str, kmer_len: int = 13, signal_len: int = 16,
                 block_rows: int = 65536):
        self._path = path
        self._kmer_len = kmer_len
        self._signal_len = signal_len
        self._block_rows = block_rows
        self._npz_files = feature_npz_paths(path)
        self._seekable = not path.endswith(".gz")
        if self._npz_files is not None:
            self._n = sum(len(load_feature_npz(f).labels)
                          for f in self._npz_files)
            self._offsets = None
        else:
            # one pass: the byte offset of every block boundary
            offsets = [0]
            n = 0
            with self._open() as rf:
                for _line in rf:
                    n += 1
                    if n % block_rows == 0:
                        offsets.append(rf.tell())
            self._n = n
            self._offsets = offsets

    def __len__(self) -> int:
        return self._n

    def _open(self):
        return (open if self._seekable else gzip.open)(self._path, "rb")

    def _iter_blocks(self, order: np.ndarray) -> Iterator[FeatureDataset]:
        if self._npz_files is not None:
            for bi in order:
                yield FeatureDataset.concat(
                    [load_feature_npz(self._npz_files[bi])])
            return
        with self._open() as rf:
            for bi in order:
                if self._seekable:
                    rf.seek(self._offsets[bi])
                raw_lines = []
                for _ in range(self._block_rows):
                    raw = rf.readline()
                    if not raw:
                        break
                    raw_lines.append(raw)
                yield FeatureDataset.concat([parse_feature_bytes(
                    b"".join(raw_lines), self._kmer_len, self._signal_len)])

    def iter_batches(self, batch_size: int, shuffle: bool,
                     rng: np.random.Generator | None = None,
                     ) -> Iterator[tuple[Batch, np.ndarray]]:
        """Yield (batch, labels) for one epoch; only the tail batch is
        short (JAX pads it; the port's step takes it as it is)."""
        rng = rng or np.random.default_rng()
        n_blocks = (len(self._npz_files) if self._npz_files is not None
                    else len(self._offsets))
        can_shuffle_blocks = shuffle and (self._npz_files is not None
                                          or self._seekable)
        order = (rng.permutation(n_blocks) if can_shuffle_blocks
                 else np.arange(n_blocks))
        carry: FeatureDataset | None = None
        for block in self._iter_blocks(order):
            if carry is not None and len(carry):
                block = FeatureDataset.concat([carry, block])
            idx = rng.permutation(len(block)) if shuffle \
                else np.arange(len(block))
            full = (len(idx) // batch_size) * batch_size
            for s in range(0, full, batch_size):
                yield block.batch_at(idx[s:s + batch_size])
            carry = block.take(idx[full:])
        if carry is not None and len(carry):
            yield carry.batch_at(slice(None))
