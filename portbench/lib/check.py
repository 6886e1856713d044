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
  pass's sampled rows (printed to 6 decimals);
- ``max_dlogit``: the largest gap over them between the reference's
  logit and the logits ln(q1 / q0) of every pair q1, q0 that prints as
  the row's prob_1, prob_0 (0 where the reference's is among them): the
  gap before the softmax, whose slope p (1 - p) would shrink a gap where
  a model's answers lie near 0 or 1, less what the print's rounding
  alone can move it by (a printed 0 leaves the logit open on its side).

Each cell compares the numbers its workload file gives a limit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

#: half a unit of the rows' sixth decimal, and then some
PRINT_ROUNDING = 1e-6
#: half a unit of the sixth decimal: what printing moves a probability by
HALF_UNIT = 5e-7
#: the gaps that a workload's limits may name, in the order reported
GAPS = ("max_dp1", "max_dlogit")


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


def logit_gap(p1: float, p0: float, ref: float) -> float:
    """How far the logit ``ref`` lies outside those of the pairs that
    print as ``p1``, ``p0``."""
    lo1, lo0 = max(p1 - HALF_UNIT, 0.0), max(p0 - HALF_UNIT, 0.0)
    lo = math.log(lo1 / (p0 + HALF_UNIT)) if lo1 > 0 else -math.inf
    hi = math.log((p1 + HALF_UNIT) / lo0) if lo0 > 0 else math.inf
    return max(lo - ref, ref - hi, 0.0)


def compare(passes, sites: int, sample, ref_p1: np.ndarray,
            ref_logit: np.ndarray, limits: dict) -> Checks:
    """``passes``: sink.PassRows of every pass; ``ref_p1``, ``ref_logit``:
    the reference's prob_1 and logit of each sampled site, in sample
    order; ``limits``: the workload's, by number."""
    gaps = [g for g in GAPS if g in limits]
    if not gaps:
        raise ValueError(f"no limit for any of {GAPS}")
    pos = {int(r): k for k, r in enumerate(sample.index)}
    missing = wrong = over = compared = 0
    widest = dict.fromkeys(gaps, 0.0)
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
            d = {"max_dp1": abs(p1 - float(ref_p1[k])),
                 "max_dlogit": logit_gap(p1, p0, float(ref_logit[k]))}
            for g in gaps:
                widest[g] = max(widest[g], d[g])
            wrong += bad
            over += (not bad) and any(d[g] > limits[g] for g in gaps)
    return Checks({"rows_missing": (missing, 0), "rows_wrong": (wrong, 0),
                   **{g: (widest[g], float(limits[g])) for g in gaps}},
                  compared, missing + wrong + over)
