"""Evaluate call_mods accuracy against known methylated / unmethylated
truth call files over a prob_cf sweep (copy of
deepsignal_plant_tpu/tools/evaluate.py).

Parity: scripts/evaluate_mods_call.py:40-140 — the 17-column stats row per
(site_num, prob_cf), AUC computed without sklearn via the rank-statistic
formulation (equivalent to roc_auc_score)."""
from __future__ import annotations

import os
import random

import numpy as np

from ..utils.formats import ModCall, open_text

NUM_SITES = [100_000]
PROB_CFS = np.arange(0, 0.70, 0.025)


def auroc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Mann-Whitney U / rank formulation of ROC-AUC; 0 when only one class
    is present (the reference catches sklearn's ValueError the same way)."""
    y_true = np.asarray(y_true, bool)
    pos = int(y_true.sum())
    neg = len(y_true) - pos
    if pos == 0 or neg == 0:
        return 0.0
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = np.asarray(y_score)[order]
    # average ranks for ties
    i = 0
    r = 1
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (r + r + (j - i)) / 2.0
        r += j - i + 1
        i = j + 1
    pos_rank_sum = ranks[y_true].sum()
    return float((pos_rank_sum - pos * (pos + 1) / 2.0) / (pos * neg))


def load_calls(path: str, is_methylated: bool, rng: random.Random
               ) -> list[tuple]:
    """(predicted_label, is_true_methylated, prob0, prob1) per row,
    shuffled (evaluate_mods_call.py:25-37)."""
    crs = []
    with open_text(path) as rf:
        for line in rf:
            m = ModCall.from_fields(line.rstrip().split())
            crs.append((m.called_label, is_methylated, m.prob0, m.prob1))
    print("there are {} basemod candidates totally".format(len(crs)))
    rng.shuffle(crs)
    return crs


def evaluate_sites(sites: list[tuple], prob_cf: float) -> str:
    pred = np.fromiter((s[0] for s in sites), dtype=np.int64,
                       count=len(sites))
    truth = np.fromiter((s[1] for s in sites), dtype=bool, count=len(sites))
    p0 = np.fromiter((s[2] for s in sites), dtype=np.float64,
                     count=len(sites))
    p1 = np.fromiter((s[3] for s in sites), dtype=np.float64,
                     count=len(sites))

    tp = int(np.sum((pred == 1) & truth))
    fp = int(np.sum((pred == 1) & ~truth))
    tn = int(np.sum((pred == 0) & ~truth))
    fn = int(np.sum((pred == 0) & truth))
    print(tp, fp, tn, fn)

    d = p1 - p0
    called_mask = np.abs(d) >= prob_cf
    called = int(called_mask.sum())
    correct = int(np.sum(((d >= prob_cf) == truth) & called_mask))

    n = len(sites)
    accuracy = float(tp + tn) / n if n else 0
    precision = float(tp) / (tp + fp) if tp + fp else 0
    fdr = float(fp) / (tp + fp) if tp + fp else 0
    recall = float(tp) / (tp + fn) if tp + fn else 0
    miss_rate = float(fn) / (tp + fn) if tp + fn else 0
    specificity = float(tn) / (tn + fp) if tn + fp else 0
    fall_out = float(fp) / (fp + tn) if tn + fp else 0
    npv = float(tn) / (tn + fn) if tn + fn else 0
    called_accuracy = float(correct) / called if called else 0
    auc = auroc(truth, p1) if n else 0

    return ("%d\t%d\t%d\t%d\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f\t"
            "%.3f\t%.3f\t%d\t%d\t%.3f\t%.3f" % (
                tp, fp, tn, fn, accuracy, recall, specificity, precision,
                fall_out, miss_rate, fdr, npv, auc, n, called,
                float(called) / n if n else 0, called_accuracy))


HEADER = ("tested_type\tprob_cf\ttrue_positive\tfalse_positive\t"
          "true_negative\tfalse_negative\taccuracy\trecall\tspecificity\t"
          "precision\tfallout\tmiss_rate\tFDR\tNPV\tauc\ttotal_num\t"
          "called_num\tcalled_ratio\tcalled_accuracy")


def evaluate_mods_call(methylated: str, unmethylated: str, result_file: str,
                       seed: int | None = None) -> None:
    rng = random.Random(seed)
    unmeth = load_calls(unmethylated, False, rng)
    meth = load_calls(methylated, True, rng)
    with open(os.path.abspath(result_file), "w") as wf:
        wf.write(HEADER + "\n")
        for site_num in NUM_SITES:
            tested = meth[:site_num] + unmeth[:site_num]
            for prob_cf in PROB_CFS:
                wf.write("\t".join(["_" + str(site_num), "%.3f" % prob_cf,
                                    evaluate_sites(tested, prob_cf)]) + "\n")
        tested = meth + unmeth
        wf.write("\t".join(["all_sites", "%.3f" % 0.0,
                            evaluate_sites(tested, 0.0)]) + "\n")


def register(tool_sub) -> None:
    p = tool_sub.add_parser("evaluate_calls",
                            description="accuracy stats of call_mods "
                                        "results vs truth sets")
    p.add_argument("--unmethylated", type=str, required=True)
    p.add_argument("--methylated", type=str, required=True)
    p.add_argument("--result_file", type=str, required=True)
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(func=lambda a: evaluate_mods_call(
        a.methylated, a.unmethylated, a.result_file, a.seed))
