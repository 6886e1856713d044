"""Seeded reads over a seeded genome, and the per-base features that
extraction would give them: the one generator every traffic kind reads
its sites from.

After chip_smoke.py's generators (``write_fast5_run``: reads as random
windows of the contigs of a seeded genome, strands alternating;
``call_mods_ab.write_dense_features``: one site per motif base, its
13-base window cut from the read, so adjacent sites share bases), with
the parameters of a traffic mix's file:

- ``contigs``: {name: length}; bases drawn with ``gc`` as the G + C share;
- ``read_len``: [shortest, longest]; every seed reads the same
  ``read_len_steps`` lengths, evenly spaced, in its own order;
- ``motif``: the base called at the site (``"C"``, mod_loc 0: every C of
  the read at least ``kmer_len // 2`` bases from either end);
- ``sites``: the input's sites; the last read's are cut at that count;
- ``label``: the methylation label column extraction writes.

Per base: a mean ~ N(0, 1), a std ~ |N(0.2, 0.08)|, a length of 3-29
signal samples and ``signal_len`` samples ~ mean + std * N(0, 1), as
MAD-normalized signal; each value is kept in micro-units (int64), the
6-decimal text that extraction writes, exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
#: extraction's motif codes (A C G T = 0 1 2 3), as the program reads them
CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
#: values are drawn within this many units of zero, so that each prints
#: with one digit before the point
VALUE_MAX = 9.5


@dataclass
class ReadChunk:
    """Consecutive reads: per-base features over their concatenated bases,
    and their sites."""
    site0: int                 # global index of the first site
    codes: np.ndarray          # (nb,) int8 base codes
    means: np.ndarray          # (nb,) int64 micro-units
    stds: np.ndarray           # (nb,) int64 micro-units
    lens: np.ndarray           # (nb,) int64 samples
    rect: np.ndarray           # (nb, S) int64 micro-units
    center: np.ndarray         # (n,) int64 base index of each site
    chrom: np.ndarray          # (n,) bytes, the contig's name
    pos: np.ndarray            # (n,) int64
    strand: np.ndarray         # (n,) bytes, b"+" or b"-"
    pos_in_strand: np.ndarray  # (n,) int64
    read_name: np.ndarray      # (n,) bytes
    label: int

    @property
    def n(self) -> int:
        return len(self.center)


def genome(rng: np.random.Generator, contigs: dict, gc: float
           ) -> dict[str, np.ndarray]:
    """Contigs of base codes, G + C drawn with probability ``gc``."""
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return {name: rng.choice(4, size=int(n), p=p).astype(np.int8)
            for name, n in contigs.items()}


def read_lengths(rng: np.random.Generator, p: dict) -> np.ndarray:
    lo, hi = p["read_len"]
    return rng.permutation(np.linspace(lo, hi, int(p["read_len_steps"])
                                       ).round().astype(np.int64))


def _read_name(rng: np.random.Generator) -> bytes:
    h = rng.bytes(16).hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}".encode()


def _micro(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x, -VALUE_MAX, VALUE_MAX) * 1e6).astype(np.int64)


def read_chunks(p: dict, seed: int, reads_per_chunk: int):
    """ReadChunks of ``reads_per_chunk`` reads until ``p["sites"]`` sites;
    the same seed gives the same chunks."""
    rng = np.random.default_rng(seed)
    contigs = genome(rng, p["contigs"], float(p["gc"]))
    names = list(contigs)
    weights = np.array([len(contigs[c]) for c in names], np.float64)
    weights /= weights.sum()
    lengths = read_lengths(rng, p)
    nb = int(p["kmer_len"]) // 2
    S = int(p["signal_len"])
    motif = CODE[p["motif"]]
    target = int(p["sites"])
    made = r = 0
    while made < target:
        codes, centers, cols = [], [], {k: [] for k in (
            "chrom", "pos", "strand", "pis", "name")}
        off = 0
        for _ in range(reads_per_chunk):
            if made >= target:
                break
            L = int(lengths[r % len(lengths)])
            c = int(rng.choice(len(names), p=weights))
            ref = contigs[names[c]]
            start = int(rng.integers(0, len(ref) - L))
            minus = r % 2 == 1
            seq = ref[start:start + L]
            if minus:
                seq = (3 - seq)[::-1]
            idx = np.flatnonzero(seq[nb:L - nb] == motif) + nb
            idx = idx[:target - made]
            gpos = (start + L - 1 - idx) if minus else (start + idx)
            codes.append(seq)
            centers.append(idx + off)
            cols["chrom"].append(np.full(len(idx), names[c].encode(), "S16"))
            cols["pos"].append(gpos)
            cols["strand"].append(np.full(len(idx), b"-" if minus else b"+"))
            cols["pis"].append((len(ref) - 1 - gpos) if minus else gpos)
            cols["name"].append(np.full(len(idx), _read_name(rng), "S36"))
            off += L
            made += len(idx)
            r += 1
        codes = np.concatenate(codes)
        n_bases = len(codes)
        means = rng.standard_normal(n_bases)
        stds = np.abs(rng.normal(0.2, 0.08, n_bases))
        lens = rng.integers(3, 30, n_bases)
        rect = means[:, None] + stds[:, None] * rng.standard_normal(
            (n_bases, S))
        center = np.concatenate(centers)
        yield ReadChunk(
            made - len(center), codes, _micro(means), _micro(stds), lens,
            _micro(rect), center, np.concatenate(cols["chrom"]),
            np.concatenate(cols["pos"]), np.concatenate(cols["strand"]),
            np.concatenate(cols["pis"]), np.concatenate(cols["name"]),
            int(p["label"]))


def windows(chunk: ReadChunk, sites: np.ndarray, kmer_len: int
            ) -> np.ndarray:
    """(len(sites), kmer_len) base indices of the chunk's local sites."""
    nb = kmer_len // 2
    return chunk.center[sites][:, None] + np.arange(-nb, nb + 1)[None, :]
