"""Device-side sort + segment-sum for call_freq aggregation (counterpart
of deepsignal_plant_tpu/ops/segment_agg.py:44-103, a jitted XLA function
there, not a Pallas kernel).

The expensive part of per-block aggregation is the O(n log n) site-key
sort (np.unique in the host path, pipeline/call_freq.py). Here one stable
``torch.sort`` orders the rows by site on the device, a comparison of
neighbours and ``cumsum`` number the sites, and ``index_add_`` gives the
exact integer segment sums (coverage, met counts). The host gets a sorted
row order it drives float64 ``np.add.at`` with.

Exactness contract (why the float sums stay on the host): the reference
accumulates per-site probability sums sequentially in file order with
Python floats (reference call_mods_freq.py:60-66, float64). A stable
sort keeps file order within each site, so host float64 adds over
``rows[order]`` associate exactly like the reference's loop and the
output stays byte-identical. Integer sums are exact in any order.

PyTorch has int64 on the device and no per-shape compiles, so the
(chrom id, position) pair is one int64 key sorted once (the JAX function
runs a two-pass 32-bit lexsort over power-of-two padded blocks). The
caller (pipeline/call_freq.FreqAccumulator._add_block) keeps the JAX
package's rule that blocks with positions past 2**31-1 take the host
path.
"""
from __future__ import annotations

import numpy as np
import torch


def sort_segment_reduce(hi: np.ndarray, lo: np.ndarray, met: np.ndarray,
                        device: torch.device | str | None = None):
    """Sort rows by (hi, lo) key and segment-sum on ``device`` (the card
    by default; ``"cpu"`` for the CPU).

    Args: integer arrays of equal length n (0 <= hi < 2**31; lo in
    [-2**31, 2**31)). Returns ``(order, seg, cov, met_sum, n_seg)`` as
    host int64 arrays: ``order`` is the stable sort permutation (file
    order kept within a key), ``seg[i]`` the segment id of sorted row i,
    ``cov``/``met_sum`` per-segment exact integer sums, ``n_seg`` the
    number of segments. One upload and one readback."""
    if not isinstance(device, torch.device):
        from ..utils.device import resolve_device
        device = resolve_device(device)
    n = len(hi)
    if n == 0:
        empty = np.empty(0, np.int64)
        return empty, empty, empty, empty, 0
    rows = torch.from_numpy(np.stack([np.asarray(a, np.int64)
                                      for a in (hi, lo, met)]))
    rows = rows.to(device)
    # lo offset by 2**31 into 32 unsigned bits; hi above them
    key = (rows[0] << 32) | (rows[1] + (1 << 31))
    _, order = torch.sort(key, stable=True)
    sk = key[order]
    new = torch.ones(n, dtype=torch.int64, device=device)
    new[1:] = (sk[1:] != sk[:-1]).long()
    seg = torch.cumsum(new, 0) - 1
    sums = torch.zeros((2, n), dtype=torch.int64, device=device)
    sums[0].index_add_(0, seg, torch.ones_like(seg))
    sums[1].index_add_(0, seg, rows[2][order])
    out = torch.cat([order[None], seg[None], sums]).cpu().numpy()
    order, seg, cov, met_sum = out
    n_seg = int(seg[-1]) + 1
    return order, seg, cov[:n_seg], met_sum[:n_seg], n_seg
