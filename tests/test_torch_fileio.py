"""The port's file helpers of denoise and the tools against the JAX
package's (deepsignal_plant_tpu/utils/fileio.py): on the same files with
the same seeded generators, in one process, they write the same bytes
and return the same values.

``select_neg_rows_as_pos_kmer_dist`` iterates Python sets of k-mer
strings, whose order follows the string hash that ``PYTHONHASHSEED``
fixes per process; both packages share that property.
``test_kmer_selection_across_hash_seeds`` prints whether two processes
with different hash seeds pick different negatives.
"""
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from deepsignal_plant_tpu.utils import fileio as jax_fileio
from deepsignal_plant_tpu_torch.utils import fileio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def feature_lines(seed: int, n: int, kmers: list[str],
                  label: int | None = None) -> list[str]:
    """12-column rows: k-mer in column 7, label in column 12."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = kmers[int(rng.integers(len(kmers)))]
        lab = int(rng.integers(2)) if label is None else label
        out.append(f"chr1\t{i}\t+\t{i}\tread{i % 7}\tt\t{k}\t0.1\t0.2\t3\t"
                   f"0.5,0.6\t{lab}\n")
    return out


def write(path, lines) -> str:
    with open(path, "w") as fh:
        fh.writelines(lines)
    return str(path)


def read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


KMERS = ["".join(random.Random(s).choices("ACGT", k=13)) for s in range(12)]


@pytest.mark.parametrize("header", [False, True])
@pytest.mark.parametrize("num_first", [0, 17, 500])
def test_random_split_rows(tmp_path, header, num_first):
    src = write(tmp_path / "rows.tsv", feature_lines(1, 60, KMERS))
    got = fileio.random_split_rows(src, str(tmp_path / "a1"),
                                   str(tmp_path / "a2"), num_first, header,
                                   rng=random.Random(5))
    want = jax_fileio.random_split_rows(src, str(tmp_path / "b1"),
                                        str(tmp_path / "b2"), num_first,
                                        header, rng=random.Random(5))
    assert got == want
    assert read(tmp_path / "a1") == read(tmp_path / "b1")
    assert read(tmp_path / "a2") == read(tmp_path / "b2")


def test_kmer_counts_and_line_indices(tmp_path):
    src = write(tmp_path / "rows.tsv", feature_lines(2, 80, KMERS))
    assert fileio.count_kmers_in_file(src) == \
        jax_fileio.count_kmers_in_file(src)
    got = fileio.kmer_to_line_indices(src)
    want = jax_fileio.kmer_to_line_indices(src)
    assert got == want and list(got) == list(want)


@pytest.mark.parametrize("case", ["quota", "neg_only", "top_up", "empty"])
def test_select_neg_rows_as_pos_kmer_dist(tmp_path, case):
    """Quotas below a k-mer's rows (rng.sample), k-mers of the negatives
    only (the spread), a shortfall topped up from unselected rows
    (rng.shuffle), and an empty positive file."""
    pos_kmers, neg_kmers, n_pos, n_neg = {
        "quota": (KMERS[:6], KMERS[:6], 40, 200),
        "neg_only": (KMERS[:3], KMERS, 40, 200),
        "top_up": (KMERS[:4], KMERS[2:], 60, 90),
        "empty": (KMERS, KMERS, 0, 30)}[case]
    pos = write(tmp_path / "pos.tsv", feature_lines(3, n_pos, pos_kmers, 1))
    neg = write(tmp_path / "neg.tsv", feature_lines(4, n_neg, neg_kmers, 0))
    got = fileio.select_neg_rows_as_pos_kmer_dist(
        pos, neg, str(tmp_path / "a.tsv"), rng=random.Random(9))
    want = jax_fileio.select_neg_rows_as_pos_kmer_dist(
        pos, neg, str(tmp_path / "b.tsv"), rng=random.Random(9))
    assert got == want
    assert read(tmp_path / "a.tsv") == read(tmp_path / "b.tsv")
    assert got == (0 if case == "empty" else
                   len(read(tmp_path / "a.tsv").splitlines()))


@pytest.mark.parametrize("label", [0, 1])
def test_filter_rows_by_label(tmp_path, label):
    src = write(tmp_path / "rows.tsv", feature_lines(5, 50, KMERS))
    got = fileio.filter_rows_by_label(src, str(tmp_path / "a"), label)
    want = jax_fileio.filter_rows_by_label(src, str(tmp_path / "b"), label)
    assert got == want > 0
    assert read(tmp_path / "a") == read(tmp_path / "b")


def test_shuffle_concat_and_count_lines(tmp_path):
    a = write(tmp_path / "a.tsv", feature_lines(6, 30, KMERS, 1))
    b = write(tmp_path / "b.tsv", feature_lines(7, 45, KMERS, 0))
    fileio.shuffle_concat(a, b, str(tmp_path / "p.tsv"), chunk_lines=8,
                          rng=np.random.default_rng(2))
    jax_fileio.shuffle_concat(a, b, str(tmp_path / "j.tsv"), chunk_lines=8,
                              rng=np.random.default_rng(2))
    assert read(tmp_path / "p.tsv") == read(tmp_path / "j.tsv")
    assert fileio.count_lines(str(tmp_path / "p.tsv")) == 75 == \
        jax_fileio.count_lines(str(tmp_path / "j.tsv"))


SELECT = """
import random, sys
from deepsignal_plant_tpu_torch.utils.fileio import \\
    select_neg_rows_as_pos_kmer_dist
select_neg_rows_as_pos_kmer_dist(sys.argv[1], sys.argv[2], sys.argv[3],
                                 rng=random.Random(9))
"""


def test_kmer_selection_across_hash_seeds(tmp_path, capsys):
    """The same seeded selection in three processes: two with one
    PYTHONHASHSEED write the same negatives; the third's hash seed may
    change the sets' order and so the picks, as in the JAX package."""
    pos = write(tmp_path / "pos.tsv", feature_lines(3, 40, KMERS[:3], 1))
    neg = write(tmp_path / "neg.tsv", feature_lines(4, 200, KMERS, 0))
    outs = []
    for i, hash_seed in enumerate(("1", "1", "2")):
        out = str(tmp_path / f"out{i}.tsv")
        env = dict(os.environ, PYTHONHASHSEED=hash_seed, PYTHONPATH=REPO)
        subprocess.run([sys.executable, "-c", SELECT, pos, neg, out],
                       env=env, check=True, timeout=120)
        outs.append(read(out))
    assert outs[0] == outs[1]
    assert len(outs[2].splitlines()) == len(outs[0].splitlines()) == 40
    with capsys.disabled():
        print(f"\nk-mer-balanced negatives, PYTHONHASHSEED 1 vs 2: "
              f"{'different rows' if outs[0] != outs[2] else 'same rows'}")
