"""The comparison that decides ``correct``: every pass's rows against the
input, and the sampled rows against the plain reference.

Numbers compared, each with its limit (a cell's ``limits`` in its
workload file; the counts' limits are 0):

- ``rows_missing``: over every pass, rows missing or extra against the
  input's sites, and a pass whose last row does not end;
- ``rows_wrong``: sampled rows whose six leading columns or centre 5-mer
  differ from the input's, that do not parse as 10 columns, or whose
  called label contradicts their own printed probabilities;
- ``max_dp1``: the largest |prob_1 - the reference's prob_1| over every
  pass's sampled rows (printed to 6 decimals).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: half a unit of the rows' sixth decimal, and then some
PRINT_ROUNDING = 1e-6


@dataclass
class Checks:
    numbers: dict            # name -> (value, limit)
    compared: int            # sampled rows compared, over every pass
    failed_rows: int

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.numbers.values())


def _row(line: bytes):
    cols = line.split(b"\t")
    if len(cols) != 10:
        return None
    try:
        p0, p1 = float(cols[6]), float(cols[7])
    except ValueError:
        return None
    return b"\t".join(cols[:6]), p0, p1, cols[8], cols[9]


def compare(passes, sites: int, sample, ref_p1: np.ndarray,
            limit_dp1: float) -> Checks:
    """``passes``: sink.PassRows of every pass; ``ref_p1``: the
    reference's prob_1 of each sampled site, in sample order."""
    pos = {int(r): k for k, r in enumerate(sample.index)}
    missing = wrong = over = compared = 0
    dp1 = 0.0
    for pr in passes:
        missing += abs(pr.rows - sites) + int(pr.ragged)
        for r, line in zip(pr.index.tolist(), pr.lines):
            k = pos[r]
            compared += 1
            row = _row(line)
            if row is None:
                wrong += 1
                continue
            info, p0, p1, label, kmer5 = row
            called = {b"0": 0, b"1": 1}.get(label)
            bad = (info != sample.info[k] or kmer5 != sample.kmer5[k]
                   or called is None
                   or (p1 > p0 + PRINT_ROUNDING and called != 1)
                   or (p0 > p1 + PRINT_ROUNDING and called != 0))
            d = abs(p1 - float(ref_p1[k]))
            dp1 = max(dp1, d)
            wrong += bad
            over += (not bad) and d > limit_dp1
    return Checks({"rows_missing": (missing, 0), "rows_wrong": (wrong, 0),
                   "max_dp1": (dp1, limit_dp1)}, compared,
                  missing + wrong + over)
