"""Text codecs of call_mods and call_freq (copy of
deepsignal_plant_tpu/utils/formats.py:26-104 and :344-425, the
pure-Python paths).

- features TSV, 12 columns (extract_features.py:381-395):
    chrom, pos, strand, pos_in_strand, readname, read_strand, kmer,
    means(csv 6dp), stds(csv 6dp), lens(csv int), signals(';'-rows of csv 6dp),
    methy_label
- call_mods TSV, 10 columns (call_modifications.py:176-188):
    chrom, pos, strand, pos_in_strand, readname, read_strand,
    prob_0(6dp), prob_1(6dp), called_label, center-5mer
- freq TSV, 11 columns / bedMethyl, 11 columns (call_mods_freq.py:100-118)
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from .bases import CODE2BASE_DNA, seq_to_codes

KEY_SEP = "||"


def open_text(path: str, mode: str = "rt"):
    """Open a possibly-gzipped text file."""
    if path.endswith(".gz"):
        return gzip.open(path, mode if "t" in mode else mode + "t")
    return open(path, mode)


def gzip_path(path: str) -> str:
    """Reference convention: force a .gz suffix when gzip output is on
    (call_modifications.py:265)."""
    return path if path.endswith(".gz") else path + ".gz"


@dataclass
class FeatureBatch:
    """A parsed block of feature rows as flat numpy arrays.

    ``sampleinfo`` holds the 6 leading text columns re-joined by tab — they
    pass through the model untouched and come back out in call_mods rows.
    """
    sampleinfo: list[str]
    kmer: np.ndarray          # (B, L) int32 base codes
    base_means: np.ndarray    # (B, L) float32
    base_stds: np.ndarray     # (B, L) float32
    base_signal_lens: np.ndarray  # (B, L) float32
    signals: np.ndarray       # (B, L, S) float32
    labels: np.ndarray        # (B,) int32

    def __len__(self) -> int:
        return len(self.sampleinfo)


def parse_feature_lines(lines: list[str], kmer_len: int = 13,
                        signal_len: int = 16) -> FeatureBatch:
    """Parse a block of features-TSV lines into a FeatureBatch.

    Numeric parity with the reference row parser (dataloader.py:14-31,
    call_modifications.py:83-117); vectorized over the block.
    """
    n = len(lines)
    sampleinfo: list[str] = []
    kmers = np.empty((n, kmer_len), dtype=np.int32)
    labels = np.empty(n, dtype=np.int32)
    means_parts: list[str] = []
    stds_parts: list[str] = []
    lens_parts: list[str] = []
    sig_parts: list[str] = []
    for i, line in enumerate(lines):
        w = line.rstrip("\n").split("\t")
        sampleinfo.append("\t".join(w[0:6]))
        kmers[i] = seq_to_codes(w[6])
        means_parts.append(w[7])
        stds_parts.append(w[8])
        lens_parts.append(w[9])
        sig_parts.append(w[10].replace(";", ","))
        labels[i] = int(w[11])

    def _csv_block(parts: list[str], count: int) -> np.ndarray:
        joined = ",".join(parts)
        return np.fromiter(map(float, joined.split(",")), dtype=np.float32,
                           count=count)

    base_means = _csv_block(means_parts, n * kmer_len).reshape(n, kmer_len)
    base_stds = _csv_block(stds_parts, n * kmer_len).reshape(n, kmer_len)
    base_signal_lens = _csv_block(lens_parts, n * kmer_len).reshape(n, kmer_len)
    signals = _csv_block(sig_parts, n * kmer_len * signal_len).reshape(
        n, kmer_len, signal_len)
    return FeatureBatch(sampleinfo, kmers, base_means, base_stds,
                        base_signal_lens, signals, labels)


def format_call_rows(sampleinfo: list[str], kmer_codes: np.ndarray,
                     prob0: np.ndarray, prob1: np.ndarray) -> list[str]:
    """Format call_mods rows from normalized probabilities.

    Parity with call_modifications.py:175-188: prob_0 normalized to
    p0/(p0+p1) rounded 6dp, prob_1 = 1 - prob_0 (rounded), called label is
    argmax, last column is the center 5-mer of the k-mer.
    """
    out = []
    for i, info in enumerate(sampleinfo):
        km = "".join(CODE2BASE_DNA[int(c)] for c in kmer_codes[i])
        p0, p1 = float(prob0[i]), float(prob1[i])
        p0n = round(p0 / (p0 + p1), 6)
        p1n = round(1 - p0n, 6)
        label = 0 if p0 >= p1 else 1
        c = len(km) // 2
        lo = max(c - 2, 0)
        hi = min(c + 3, len(km))
        out.append("\t".join([info, str(p0n), str(p1n), str(label),
                              km[lo:hi]]))
    return out


@dataclass
class ModCall:
    """One parsed call_mods row (utils/txt_formater.py:8)."""
    chrom: str
    pos: int
    strand: str
    pos_in_strand: int
    readname: str
    read_strand: str
    prob0: float
    prob1: float
    called_label: int
    kmer: str

    @classmethod
    def from_fields(cls, w: list[str]) -> "ModCall":
        return cls(w[0], int(w[1]), w[2], int(w[3]), w[4], w[5],
                   float(w[6]), float(w[7]), int(w[8]), w[9])

    @property
    def site_key(self) -> str:
        return KEY_SEP.join([self.chrom, str(self.pos)])

    def is_callable(self, prob_cf: float) -> bool:
        """Keep non-ambiguous calls: |p0-p1| >= prob_cf (txt_formater.py:23)."""
        return abs(self.prob0 - self.prob1) >= prob_cf


def split_site_key(key: str) -> tuple[str, int]:
    chrom, pos = key.split(KEY_SEP)
    return chrom, int(pos)


def format_freq_row(chrom: str, pos: int, strand: str, pos_in_strand: int,
                    prob0_sum: float, prob1_sum: float, met: int, unmet: int,
                    coverage: int, rmet: float, kmer: str) -> str:
    """11-column freq row (call_mods_freq.py:112 printf formats)."""
    return "%s\t%d\t%s\t%d\t%.3f\t%.3f\t%d\t%d\t%d\t%.4f\t%s" % (
        chrom, pos, strand, pos_in_strand, prob0_sum, prob1_sum, met, unmet,
        coverage, rmet, kmer)


def format_bed_row(chrom: str, pos: int, strand: str, coverage: int,
                   rmet: float) -> str:
    """bedMethyl row (call_mods_freq.py:107-110), including the reference's
    +0.001 rounding nudge on the percentage."""
    pct = str(int(round(rmet * 100 + 0.001, 0)))
    return "\t".join([chrom, str(pos), str(pos + 1), ".", str(coverage),
                      strand, str(pos), str(pos + 1), "0,0,0", str(coverage),
                      pct])
