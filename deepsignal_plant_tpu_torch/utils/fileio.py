"""File-level utilities: line counting, shuffled concatenation and fast5
discovery (copy of the parts of deepsignal_plant_tpu/utils/fileio.py that
the tools and extract call; the k-mer sampling comes with denoise).

Behavioral parity targets: deepsignal_plant/utils/process_utils.py:148-161
(get_fast5s), :198-207 (count_line_num) and :358-390 (concat_two_files).
"""
from __future__ import annotations

import fnmatch
import os

import numpy as np

from .formats import open_text


def count_lines(path: str, header: bool = False) -> int:
    n = 0
    with open_text(path) as rf:
        for _ in rf:
            n += 1
    return n - 1 if header and n > 0 else n


def get_fast5s(fast5_dir: str, recursive: bool = True) -> list[str]:
    """All .fast5 files under a directory (process_utils.py:148)."""
    fast5_dir = os.path.abspath(fast5_dir)
    fast5s: list[str] = []
    if recursive:
        for root, _dirs, files in os.walk(fast5_dir):
            for fn in fnmatch.filter(files, "*.fast5"):
                fast5s.append(os.path.join(root, fn))
    else:
        for fn in os.listdir(fast5_dir):
            if fn.endswith(".fast5"):
                fast5s.append("/".join([fast5_dir, fn]))
    return fast5s


def shuffle_concat(file1: str, file2: str, out_file: str,
                   chunk_lines: int = 2_000_000, header: bool = False,
                   rng: np.random.Generator | None = None) -> None:
    """Concatenate two row files into one with chunk-level shuffling, keeping
    the two sources interleaved proportionally to their sizes.

    Parity: concat_two_files (process_utils.py:358) — reads proportional
    chunks from each file, shuffles the union, appends.
    """
    rng = rng or np.random.default_rng()
    n1 = count_lines(file1, header)
    n2 = count_lines(file2, False)
    chunk2 = int(round(chunk_lines * (float(n2) / n1 if n1 else 1.0))) + 1

    with open(out_file, "w") as wf, open_text(file1) as rf1, \
            open_text(file2) as rf2:
        if header:
            wf.write(next(rf1))
        while True:
            block = []
            for _ in range(chunk_lines):
                line = rf1.readline()
                if not line:
                    break
                block.append(line)
            for _ in range(chunk2):
                line = rf2.readline()
                if not line:
                    break
                block.append(line)
            if not block:
                break
            order = rng.permutation(len(block))
            for i in order:
                wf.write(block[i])
