"""Traffic kind ``npz_packed``: the reads' sites as a directory of v3
read-packed containers (what ``extract --w_format npz_packed`` writes:
one container per ``reads_per_file`` reads, float16 values), written by
the benchmark's frozen copy of the v3 writer."""
from __future__ import annotations

import os

import numpy as np

from portbench.lib import sample as smp
from portbench.lib import text
from portbench.lib.npzv3 import save_packed_npz
from portbench.lib.reads import read_chunks


def make(p: dict, seed: int, workdir: str, check_sites: int) -> smp.Input:
    L = int(p["kmer_len"])
    path = os.path.join(workdir, "features_v3")
    os.makedirs(path)
    index = smp.draw(seed, int(p["sites"]), check_sites)
    keep = smp.Collector(index, L, np.float16)
    nbytes = 0
    for i, chunk in enumerate(read_chunks(p, seed,
                                          int(p["reads_per_file"]))):
        keep.add(chunk)
        blob, lens = text.join(text.info_parts(chunk,
                                               np.arange(chunk.n)))
        ends = np.cumsum(lens)
        f = os.path.join(path, f"{i:05d}.npz")
        save_packed_npz(
            f, info_blob=blob, row_starts=ends - lens, info_ends=ends,
            centers=chunk.center, codes=chunk.codes,
            means=chunk.means / 1e6, stds=chunk.stds / 1e6,
            lens=chunk.lens, rect=chunk.rect / 1e6,
            labels=np.full(chunk.n, chunk.label), kmer_len=L)
        nbytes += os.path.getsize(f)
    return smp.Input(path, int(p["sites"]), nbytes, keep.finish())
