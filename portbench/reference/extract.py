"""The plain extraction reference: a site's model inputs from what one
single-read tombo fast5 holds, in numpy, after deepsignal-plant's
``extract_features.py`` (``_get_label_raw``, ``_rescale_signals``,
``_normalize_signals``, ``_get_signals_rect``, ``_extract_features``).
It imports nothing of the program and is given the values that the
benchmark wrote into the file, not the file: the program reads the file.

Per read:

1. DAC to picoamps: ``range / digitisation * (dac + offset)``;
2. median/MAD normalisation over the whole raw signal,
   MAD / 0.6744897501960817 (statsmodels' ``robust.mad``), rounded to 6
   decimals; an event's samples start at ``read_start_rel_to_raw`` plus
   its own start;
3. per base: the mean and the population standard deviation of its
   samples (each rounded to 6 decimals) and its number of samples;
4. the 16-sample rectangle: "even" downsampling above 16 samples (sample
   ``i * n // 16``), the samples centred between zeros below;
5. per site (every motif base at least ``kmer_len // 2`` from either
   end): its ``kmer_len``-base window, its genome position on either
   strand and ``pos_in_strand`` against the contig's length.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: Gaussian.ppf(3/4): the MAD's consistency constant
MAD_C = 0.6744897501960817
#: the model's base codes (A C G T = 0 1 2 3), by ASCII byte
CODES = np.full(256, -1, np.int64)
CODES[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)


@dataclass
class Fast5Read:
    """What one tombo fast5 holds, as written."""
    readname: str
    chrom: str
    mapped_start: int
    strand: str              # the alignment's strand, "+" or "-"
    dac: np.ndarray          # (ns,) int16 raw samples
    digitisation: float
    prange: float
    offset: float
    rel: int                 # read_start_rel_to_raw
    bases: bytes             # the event table's bases, in read order
    starts: np.ndarray       # (nb,) event starts, from rel
    lengths: np.ndarray      # (nb,) event lengths


def picoamps(read: Fast5Read, at=slice(None)) -> np.ndarray:
    """Step 1, of the samples ``at``."""
    return read.prange / read.digitisation * (
        read.dac[at].astype(np.float64) + read.offset)


def shift_scale(read: Fast5Read) -> tuple[float, float]:
    """Step 2's median and MAD / 0.6745 over the read's whole signal."""
    pa = picoamps(read)
    med = float(np.median(pa))
    return med, float(np.median(np.abs(pa - med)) / MAD_C)


def normalized(pa: np.ndarray, shift: float, scale: float) -> np.ndarray:
    """Step 2 (a scale of 0 leaves the signal as it is), rounded to 6
    decimals."""
    return np.around(pa if scale == 0 else (pa - shift) / scale,
                     decimals=6)


def sites(read: Fast5Read, motif: str, mod_loc: int, kmer_len: int
          ) -> np.ndarray:
    """Step 5's sites: read positions of every motif hit's modified base
    at least ``kmer_len // 2`` bases from either end."""
    seq = np.frombuffer(read.bases, np.uint8)
    m = np.frombuffer(motif.encode(), np.uint8)
    n = len(seq) - len(m) + 1
    hit = np.ones(max(n, 0), bool)
    for j, b in enumerate(m):
        hit &= seq[j:j + n] == b
    loc = np.flatnonzero(hit) + mod_loc
    nb = kmer_len // 2
    return loc[(loc >= nb) & (loc < len(seq) - nb)]


def base_features(read: Fast5Read, bases: np.ndarray, shift: float,
                  scale: float, signal_len: int):
    """Steps 3 and 4 for the read's ``bases``: means, stds, lengths
    (float64) and the (n, signal_len) rectangle."""
    lo = read.rel + read.starts[bases].astype(np.int64)
    n = read.lengths[bases].astype(np.int64)
    width = max(int(n.max()), signal_len)
    at = np.arange(width)[None, :]
    inside = at < n[:, None]
    seg = np.where(inside, normalized(picoamps(read, np.minimum(
        lo[:, None] + at, len(read.dac) - 1)), shift, scale), 0.0)
    means = seg.sum(1) / n
    stds = np.sqrt((np.where(inside, seg - means[:, None], 0.0) ** 2
                    ).sum(1) / n)
    S = np.arange(signal_len)[None, :]
    pick = np.where(n[:, None] > signal_len, S * n[:, None] // signal_len,
                    S - (signal_len - n[:, None]) // 2)
    keep = (pick >= 0) & (pick < n[:, None])
    rect = np.where(keep, np.take_along_axis(
        seg, np.clip(pick, 0, width - 1), 1), 0.0)
    return (np.around(means, 6), np.around(stds, 6), n.astype(np.float64),
            rect)


def site_features(read: Fast5Read, chrom_len: int, centres: np.ndarray,
                  kmer_len: int, signal_len: int,
                  shift_scale: tuple[float, float]) -> dict:
    """The model inputs and the six leading output columns of the read's
    sites at ``centres`` (read positions); ``shift_scale`` the read's
    (``shift_scale(read)``)."""
    nb = kmer_len // 2
    win = centres[:, None] + np.arange(-nb, nb + 1)[None, :]
    uniq, inv = np.unique(win, return_inverse=True)
    means, stds, lens, rect = base_features(read, uniq, *shift_scale,
                                            signal_len)
    inv = inv.reshape(win.shape)
    L = len(read.bases)
    pos = (read.mapped_start + L - 1 - centres if read.strand == "-"
           else read.mapped_start + centres)
    pis = chrom_len - 1 - pos if read.strand == "-" else pos
    seq = np.frombuffer(read.bases, np.uint8)
    info = [f"{read.chrom}\t{p}\t{read.strand}\t{q}\t{read.readname}\tt"
            .encode() for p, q in zip(pos.tolist(), pis.tolist())]
    return {"info": info,
            "kmer": CODES[seq[win]],
            "kmer5": [seq[c - 2:c + 3].tobytes() for c in centres.tolist()],
            "means": means[inv].astype(np.float32),
            "stds": stds[inv].astype(np.float32),
            "lens": lens[inv].astype(np.float32),
            "signals": rect[inv].astype(np.float32)}
