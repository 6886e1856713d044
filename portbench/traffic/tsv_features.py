"""Traffic kind ``tsv_features``: the reads' sites as a features TSV in
the reference ``extract`` format (12 columns: chrom, pos, strand,
pos_in_strand, read name, read strand, k-mer, per-base means, stds and
signal lengths, the per-base signal rows, label), means, stds and
signals as ``%.6f`` text, rows in read order."""
from __future__ import annotations

import os

import numpy as np

from portbench.lib import sample as smp
from portbench.lib import text
from portbench.lib.reads import BASES, read_chunks, windows

#: reads generated at a time, and rows formatted at a time
READS_PER_CHUNK = 8
ROWS_PER_BLOCK = 4096


def base_tokens(chunk) -> dict:
    """Each base's fields as text parts, once a chunk: sites share
    their bases' text."""
    S = chunk.rect.shape[1]
    sig = text.separated(text.micro6(chunk.rect), ",")
    return {"means": text.micro6(chunk.means),
            "stds": text.micro6(chunk.stds),
            "lens": text.uints(chunk.lens, 2),
            "sig": tuple(a.reshape(len(chunk.codes), S * 10) for a in sig)}


def rows(chunk, tokens: dict, sites: np.ndarray, L: int) -> bytes:
    """The sites' feature rows, newline-terminated."""
    n = len(sites)
    win = windows(chunk, sites, L)
    tab = text.const(n, b"\t")
    kmer = BASES[chunk.codes[win]]

    def field(name, sep):
        return text.separated(tuple(a[win] for a in tokens[name]), sep)
    parts = text.info_parts(chunk, sites) + [
        tab, (kmer, np.ones(kmer.shape, bool)), tab,
        field("means", ","), tab, field("stds", ","), tab,
        field("lens", ","), tab, field("sig", ";"),
        text.const(n, b"\t%d\n" % chunk.label)]
    return text.join(parts)[0]


def make(p: dict, seed: int, workdir: str, check_sites: int) -> smp.Input:
    L = int(p["kmer_len"])
    path = os.path.join(workdir, "features.tsv")
    index = smp.draw(seed, int(p["sites"]), check_sites)
    keep = smp.Collector(index, L, np.float32)
    nbytes = 0
    with open(path, "wb") as fh:
        for chunk in read_chunks(p, seed, READS_PER_CHUNK):
            keep.add(chunk)
            tokens = base_tokens(chunk)
            for lo in range(0, chunk.n, ROWS_PER_BLOCK):
                block = rows(chunk, tokens, np.arange(
                    lo, min(chunk.n, lo + ROWS_PER_BLOCK)), L)
                fh.write(block)
                nbytes += len(block)
    return smp.Input(path, int(p["sites"]), nbytes, keep.finish())
