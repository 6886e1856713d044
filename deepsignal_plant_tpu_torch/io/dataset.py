"""Training dataset: a features TSV parsed once into dense host arrays
(counterpart of deepsignal_plant_tpu/io/dataset.py:23-97).

The file is parsed a single time by the native parser at float32
(utils/fastparse.parse_feature_bytes, the same arrays as the plain
utils/formats.parse_feature_lines; labels are column 12); epochs are
permutations of an index vector and batches are gathers. npz feature
inputs and the streaming (block-shuffled) dataset of the JAX package are
not ported yet.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..models.bilstm import Batch
from ..utils.fastparse import parse_feature_bytes
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
        """Parse a features TSV (plain or .gz) into one dataset."""
        if path.endswith(".npz") or os.path.isdir(path):
            raise ValueError(
                f"{path}: .npz feature inputs are not yet ported to "
                "deepsignal_plant_tpu_torch (the JAX package "
                "deepsignal_plant_tpu serves them)")
        parts = [p for p in (parse_feature_bytes(block, kmer_len,
                                                 signal_len)
                             for block in iter_byte_blocks(path, block_bytes))
                 if len(p)]
        if not parts:
            z = np.zeros
            return cls(z((0, kmer_len), np.int32),
                       z((0, kmer_len), np.float32),
                       z((0, kmer_len), np.float32),
                       z((0, kmer_len), np.float32),
                       z((0, kmer_len, signal_len), np.float32),
                       z((0,), np.int32))
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
                     drop_last: bool = False, pad_to_batch: bool = False,
                     ) -> Iterator[tuple[Batch, np.ndarray, int]]:
        """Yield (batch, labels, n_valid). With ``pad_to_batch`` every
        batch has ``batch_size`` rows, the tail padded with row 0."""
        n = len(self)
        order = (rng or np.random.default_rng()).permutation(n) \
            if shuffle else np.arange(n)
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            n_valid = len(idx)
            if n_valid < batch_size:
                if drop_last:
                    return
                if pad_to_batch:
                    pad = np.zeros(batch_size - n_valid, dtype=idx.dtype)
                    idx = np.concatenate([idx, pad])
            batch, labels = self.batch_at(idx)
            yield batch, labels, n_valid
