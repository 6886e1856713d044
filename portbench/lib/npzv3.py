"""A frozen copy of the v3 (read-packed wire) feature container writer
(deepsignal_plant_tpu_torch/utils/formats.py::save_packed_npz as of this
benchmark's first version): the benchmark writes its own containers, so
a later change to the program's writer cannot change the input."""
from __future__ import annotations

import numpy as np


def save_packed_npz(path: str, *, info_blob: bytes, row_starts, info_ends,
                    centers, codes, means, stds, lens, rect, labels,
                    kmer_len: int) -> None:
    """Deduplicated per-base arrays (codes int8; means, stds, lens and
    the (nb, S) signal rows float16), per-site window centres into them
    (int32, non-decreasing), and each site's six leading columns as
    spans of one byte blob."""
    np.savez(path,
             wire_version=np.uint8(3),
             kmer_len=np.int32(kmer_len),
             info_blob=np.frombuffer(info_blob, np.uint8),
             row_starts=np.asarray(row_starts, np.int64),
             info_ends=np.asarray(info_ends, np.int64),
             centers=np.asarray(centers, np.int32),
             codes=np.asarray(codes, np.int8),
             base_means=np.asarray(means, np.float16),
             base_stds=np.asarray(stds, np.float16),
             base_signal_lens=np.asarray(lens, np.float16),
             signals=np.asarray(rect, np.float16),
             labels=np.asarray(labels, np.int32))
