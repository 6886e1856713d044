"""File-level utilities: line counting, random splitting, shuffled
concatenation, k-mer-balanced sampling and fast5 discovery (copy of
deepsignal_plant_tpu/utils/fileio.py:24-214 without ``is_file_empty``).

The random helpers draw in the JAX package's order, call for call, so a
seeded generator gives the same rows in both packages. Sets of k-mer
strings iterate in the order of Python's string hash, which
``PYTHONHASHSEED`` fixes per process: in one process both packages pick
the same negatives; across processes a seeded selection may differ.

Behavioral parity targets: deepsignal_plant/utils/process_utils.py:148-161
(get_fast5s), :198-207 (count_line_num), :263-317
(random_select_file_rows_s), :358-390 (concat_two_files), :404-529
(k-mer-balanced negative sampling).
"""
from __future__ import annotations

import fnmatch
import math
import os
import random

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


def random_split_rows(ori_file: str, w_file: str, w_other_file: str,
                      num_first: int, header: bool = False,
                      rng: random.Random | None = None
                      ) -> tuple[list[int], list[int]]:
    """Randomly split the rows of ``ori_file`` into two files; the first
    gets ``num_first`` rows (or all rows if fewer). Returns the 0-based
    original line indices that landed in each file, both increasing.

    Parity: random_select_file_rows_s (process_utils.py:263) — one
    streaming pass, selection without replacement.
    """
    rng = rng or random
    nrows = count_lines(ori_file, header)
    take = min(num_first, nrows)
    chosen = np.zeros(nrows, dtype=bool)
    chosen[rng.sample(range(nrows), take)] = True

    idxs1: list[int] = []
    idxs2: list[int] = []
    with open_text(ori_file) as rf, open(w_file, "w") as wf, \
            open(w_other_file, "w") as wof:
        if header:
            h = next(rf)
            wf.write(h)
            wof.write(h)
        for i, line in enumerate(rf):
            if chosen[i]:
                wf.write(line)
                idxs1.append(i)
            else:
                wof.write(line)
                idxs2.append(i)
    return idxs1, idxs2


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


KMER_COL = 6  # k-mer column index in the features TSV


def count_kmers_in_file(path: str, col: int = KMER_COL) -> dict[str, int]:
    """k-mer -> row count over a features file (process_utils.py:405)."""
    counts: dict[str, int] = {}
    with open_text(path) as rf:
        for line in rf:
            kmer = line.split("\t", col + 1)[col]
            counts[kmer] = counts.get(kmer, 0) + 1
    return counts


def kmer_to_line_indices(path: str, col: int = KMER_COL
                         ) -> dict[str, list[int]]:
    """k-mer -> 0-based line indices (process_utils.py:429)."""
    k2l: dict[str, list[int]] = {}
    with open_text(path) as rf:
        for i, line in enumerate(rf):
            kmer = line.split("\t", col + 1)[col]
            k2l.setdefault(kmer, []).append(i)
    return k2l


def select_neg_rows_as_pos_kmer_dist(pos_file: str, neg_file: str,
                                     out_file: str,
                                     rng: random.Random | None = None) -> int:
    """Select rows of ``neg_file`` so that their k-mer distribution
    matches ``pos_file`` and write them to ``out_file`` in their original
    order. Returns the number of rows written.

    Parity: select_negsamples_asposkmer (process_utils.py:522) — per-kmer
    quota = ceil(total_pos * pos_ratio); leftover quota spread over
    k-mers unseen in the positive set, then topped up from unselected
    rows. The k-mer sets iterate in hash order, as in the JAX package.
    """
    rng = rng or random
    pos_counts = count_kmers_in_file(pos_file)
    total = sum(pos_counts.values())
    ratios = {k: c / total for k, c in pos_counts.items()} if total else {}

    k2lines = kmer_to_line_indices(neg_file)
    common = set(k2lines) & set(ratios)
    neg_only = set(k2lines) - set(ratios)

    selected: list[int] = []
    unselected: list[int] = []
    for kmer in common:
        quota = int(math.ceil(total * ratios[kmer]))
        lines = k2lines[kmer]
        if len(lines) <= quota:
            selected += lines
        else:
            picked = rng.sample(lines, quota)
            selected += picked
            unselected += list(set(lines) - set(picked))

    unfilled = total - len(selected)
    if unfilled > 0 and neg_only:
        per_kmer = int(math.ceil(unfilled / len(neg_only)))
        for kmer in neg_only:
            lines = k2lines[kmer]
            if len(lines) <= per_kmer:
                selected += lines
            else:
                picked = rng.sample(lines, per_kmer)
                selected += picked
                unselected += list(set(lines) - set(picked))

    unfilled = total - len(selected)
    if unfilled > 0 and unselected:
        rng.shuffle(unselected)
        selected += unselected[:unfilled]

    wanted = np.zeros(max(selected) + 1 if selected else 0, dtype=bool)
    for i in selected:
        wanted[i] = True
    written = 0
    with open_text(neg_file) as rf, open(out_file, "w") as wf:
        for i, line in enumerate(rf):
            if i < len(wanted) and wanted[i]:
                wf.write(line)
                written += 1
    return written


def filter_rows_by_label(path: str, out_file: str, label: int,
                         label_col: int = 11) -> int:
    """Write only the rows whose label column equals ``label``
    (denoise.py:296-308). Returns the row count."""
    n = 0
    with open_text(path) as rf, open(out_file, "w") as wf:
        for line in rf:
            if int(line.rstrip("\n").split("\t")[label_col]) == label:
                wf.write(line)
                n += 1
    return n
