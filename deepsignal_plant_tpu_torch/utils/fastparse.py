"""Python side of the native codecs (native/featparse.cpp; copy of
deepsignal_plant_tpu/utils/fastparse.py:329-633, the parts the TSV plane
of call_mods, the dataset and call_freq call).

- ``parse_feature_bytes``: a newline-terminated byte block -> FeatureBatch
  (float32, or the float16 wire: int8 codes, IEEE halves);
- ``parse_raw_feature_block``: the float16 wire plus byte spans of each
  row's 6 info columns, with no per-row Python string;
- ``pack_raw_block``: the read-packed wire (deduplicated per-base arrays
  and int32 window centres) rebuilt from parsed rows;
- ``emit_call_rows_arrays`` and ``format_call_block``: call_mods rows;
- ``parse_call_bytes``: call_mods rows -> CallBlock (call_freq's input).

Every call builds the library if needed (native.load) and raises if it
cannot; there is no Python fallback. utils/formats.py keeps the plain
Python codecs, against which the tests hold these.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from .formats import FeatureBatch


def _parse(block: bytes, kmer_len: int, signal_len: int, f16: bool):
    """(kmer, means, stds, slens, signals, labels, row_starts, info_ends)
    of a byte block's rows; float16 wire (int8 codes) or float32 (int32
    codes)."""
    lib = native.load()
    fdt = np.float16 if f16 else np.float32
    n_max = lib.dsp_count_lines(block, len(block))
    kmer = np.empty((n_max, kmer_len), np.int8 if f16 else np.int32)
    means = np.empty((n_max, kmer_len), fdt)
    stds = np.empty((n_max, kmer_len), fdt)
    slens = np.empty((n_max, kmer_len), fdt)
    signals = np.empty((n_max, kmer_len, signal_len), fdt)
    labels = np.empty(n_max, np.int32)
    row_starts = np.empty(n_max, np.int64)
    info_ends = np.empty(n_max, np.int64)
    n = 0
    if n_max:
        if f16:
            n = lib.dsp_parse_features_f16(
                block, len(block), kmer_len, signal_len, kmer,
                means.view(np.uint16), stds.view(np.uint16),
                slens.view(np.uint16), signals.view(np.uint16), labels,
                row_starts, info_ends)
        else:
            n = lib.dsp_parse_features(
                block, len(block), kmer_len, signal_len, kmer, means, stds,
                slens, signals, labels, row_starts, info_ends)
        if n < 0:
            raise ValueError(f"malformed features row at line {-n - 1}")
    return tuple(a[:n] for a in (kmer, means, stds, slens, signals, labels,
                                 row_starts, info_ends))


def parse_feature_bytes(block: bytes, kmer_len: int = 13,
                        signal_len: int = 16,
                        out_dtype: str = "float32") -> FeatureBatch:
    """Parse a features byte block natively. ``out_dtype`` "float16"
    fills the float16 wire (int8 base codes, halves written by the
    parser itself), "float32" the dataset's arrays (int32 codes)."""
    *arrays, starts, ends = _parse(block, kmer_len, signal_len,
                                   out_dtype == "float16")
    sampleinfo = [block[a:b].decode()
                  for a, b in zip(starts.tolist(), ends.tolist())]
    return FeatureBatch(sampleinfo, *arrays)


class RawFeatureBlock:
    """Wire-format parsed features with byte spans instead of decoded
    sampleinfo strings. Output rows are emitted natively by copying
    columns 0-5 straight from ``raw`` (dsp_emit_call_rows)."""
    __slots__ = ("raw", "row_starts", "info_ends", "kmer", "means", "stds",
                 "slens", "signals", "labels")

    def __init__(self, raw, row_starts, info_ends, kmer, means, stds,
                 slens, signals, labels):
        self.raw = raw
        self.row_starts = row_starts    # (n,) int64 offsets into raw
        self.info_ends = info_ends      # (n,) int64
        self.kmer = kmer                # (n, L) int8
        self.means = means              # (n, L) f16
        self.stds = stds
        self.slens = slens
        self.signals = signals          # (n, L, S) f16
        self.labels = labels            # (n,) int32

    @property
    def n(self) -> int:
        return len(self.labels)


def parse_raw_feature_block(block: bytes, kmer_len: int = 13,
                            signal_len: int = 16) -> RawFeatureBlock:
    """Parse a features byte block into the float16 wire plus the byte
    spans of each row's info columns (no per-row Python strings)."""
    (kmer, means, stds, slens, signals, labels, starts,
     ends) = _parse(block, kmer_len, signal_len, True)
    return RawFeatureBlock(block, starts, ends, kmer, means, stds, slens,
                           signals, labels)


def emit_call_rows_arrays(raw: bytes, starts: np.ndarray, ends: np.ndarray,
                          kmer: np.ndarray, probs: np.ndarray) -> bytes:
    """Complete call_mods rows from the info columns' byte spans in
    ``raw``, the sites' int8 k-mer codes and (n, 2) probabilities."""
    lib = native.load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    kmer = np.ascontiguousarray(kmer, np.int8)
    probs = np.ascontiguousarray(probs, np.float32)
    if kmer.shape[0] != n or probs.shape != (n, 2) or len(ends) != n:
        raise ValueError(f"{n} rows, k-mers {kmer.shape}, probabilities "
                         f"{probs.shape}")
    if n and (starts.min() < 0 or ends.max() > len(raw)
              or (ends < starts).any()):
        raise ValueError("info spans outside the raw block")
    out = np.empty(int((ends - starts).sum()) + n * 40, np.uint8)
    total = lib.dsp_emit_call_rows(raw, starts, ends, probs, kmer, n,
                                   kmer.shape[1], out)
    return out[:total].tobytes()


class PackedFeatureBlock:
    """Read-packed wire features: deduplicated per-base arrays over
    concatenated reads plus per-site int32 window centres.

    Adjacent motif sites of one read share ``kmer_len - 1`` of their
    ``kmer_len`` window bases, so a per-site wire re-ships every base up
    to kmer_len times. Packing the base axis once and gathering the
    windows on the device cuts the bytes by ~kmer_len/(bases per site),
    ~3x for dense plant C motifs. ``centers`` is non-decreasing, so a
    batch can end at any site by slicing the covering base range."""
    __slots__ = ("raw", "row_starts", "info_ends", "centers", "codes",
                 "means", "stds", "lens", "rect", "labels", "kmer_len")

    def __init__(self, raw, row_starts, info_ends, centers, codes, means,
                 stds, lens, rect, labels, kmer_len):
        self.raw = raw                  # info byte blob (cols 0-5 per site)
        self.row_starts = row_starts    # (n,) int64 offsets into raw
        self.info_ends = info_ends      # (n,) int64
        self.centers = centers          # (n,) int32 offsets into base axis
        self.codes = codes              # (nb,) int8 base codes
        self.means = means              # (nb,) f16
        self.stds = stds                # (nb,) f16
        self.lens = lens                # (nb,) f16
        self.rect = rect                # (nb, S) f16
        self.labels = labels            # (n,) int32
        self.kmer_len = kmer_len

    @property
    def n(self) -> int:
        return len(self.labels)

    @property
    def n_bases(self) -> int:
        return len(self.codes)

    def window_index(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        """(n, kmer_len) base-axis gather indices for sites [lo, hi)."""
        nb = (self.kmer_len - 1) // 2
        c = self.centers[lo:hi if hi is not None else self.n]
        return c[:, None].astype(np.int64) + np.arange(-nb, nb + 1)[None, :]


def pack_raw_block(rb: RawFeatureBlock) -> PackedFeatureBlock:
    """Rebuild the read-packed wire from parsed per-site rows
    (dsp_pack_rows). Dedup is conservative: a row joins the previous
    row's run only when its identity columns match and every overlapping
    window byte is identical, so any row order gives the same windows;
    rows out of extraction order just pack worse."""
    lib = native.load()
    n, L = rb.kmer.shape
    S = rb.signals.shape[2]
    cap = n * L
    codes = np.empty(cap, np.int8)
    means = np.empty(cap, np.float16)
    stds = np.empty(cap, np.float16)
    lens = np.empty(cap, np.float16)
    rect = np.empty((cap, S), np.float16)
    centers = np.empty(n, np.int32)
    nb_out = lib.dsp_pack_rows(
        rb.raw, np.ascontiguousarray(rb.row_starts),
        np.ascontiguousarray(rb.info_ends),
        np.ascontiguousarray(rb.kmer),
        np.ascontiguousarray(rb.means).view(np.uint16),
        np.ascontiguousarray(rb.stds).view(np.uint16),
        np.ascontiguousarray(rb.slens).view(np.uint16),
        np.ascontiguousarray(rb.signals).view(np.uint16), n, L, S,
        codes, means.view(np.uint16), stds.view(np.uint16),
        lens.view(np.uint16), rect.reshape(-1).view(np.uint16), centers)
    if nb_out < 0:
        raise ValueError(f"malformed info columns at row {-nb_out - 1}")
    nb_out = int(nb_out)
    return PackedFeatureBlock(rb.raw, rb.row_starts, rb.info_ends, centers,
                              codes[:nb_out], means[:nb_out],
                              stds[:nb_out], lens[:nb_out], rect[:nb_out],
                              rb.labels, L)


class CallBlock:
    """Parsed call_mods rows (struct-of-arrays) from one byte block."""
    __slots__ = ("chroms", "chrom_ids", "pos", "strand", "pos_in_strand",
                 "p0", "p1", "label", "kmer_off", "kmer_len", "raw")

    def __init__(self, chroms, chrom_ids, pos, strand, pos_in_strand, p0,
                 p1, label, kmer_off, kmer_len, raw):
        self.chroms = chroms            # list[str], block-local intern table
        self.chrom_ids = chrom_ids      # (n,) int32 indexes into chroms
        self.pos = pos                  # (n,) int64
        self.strand = strand            # (n,) uint8 ('+' / '-' ordinals)
        self.pos_in_strand = pos_in_strand  # (n,) int64
        self.p0 = p0                    # (n,) float64
        self.p1 = p1                    # (n,) float64
        self.label = label              # (n,) int32 called label
        self.kmer_off = kmer_off        # (n,) int64 offsets into raw
        self.kmer_len = kmer_len        # (n,) int32
        self.raw = raw                  # the input bytes (kmer storage)

    def __len__(self) -> int:
        return len(self.pos)

    def kmer_at(self, i: int) -> str:
        off = int(self.kmer_off[i])
        return self.raw[off:off + int(self.kmer_len[i])].decode()


def parse_call_bytes(block: bytes) -> CallBlock:
    """Parse a newline-terminated call_mods byte block natively; raises
    on a malformed row."""
    lib = native.load()
    n_max = lib.dsp_count_lines(block, len(block))
    chrom_ids = np.empty(n_max, np.int32)
    pos = np.empty(n_max, np.int64)
    strand = np.empty(n_max, np.uint8)
    pis = np.empty(n_max, np.int64)
    p0 = np.empty(n_max, np.float64)
    p1 = np.empty(n_max, np.float64)
    label = np.empty(n_max, np.int32)
    kmer_off = np.empty(n_max, np.int64)
    kmer_len = np.empty(n_max, np.int32)
    cap = 4 << 20
    chrom_buf = ctypes.create_string_buffer(cap)
    n_chroms = ctypes.c_int32(0)
    n = lib.dsp_parse_calls(block, len(block), chrom_ids, pos, strand, pis,
                            p0, p1, label, kmer_off, kmer_len, chrom_buf,
                            cap, ctypes.byref(n_chroms))
    if n == np.iinfo(np.int64).min:
        raise ValueError("chromosome-name table exceeded 4 MiB")
    if n < 0:
        raise ValueError(f"malformed call_mods row at line {-n - 1}")
    n = int(n)
    names = chrom_buf.raw[:chrom_buf.raw.index(b"\x00")].decode()
    chroms = names.split("\n")[:n_chroms.value] if n else []
    return CallBlock(chroms, chrom_ids[:n], pos[:n], strand[:n], pis[:n],
                     p0[:n], p1[:n], label[:n], kmer_off[:n], kmer_len[:n],
                     block)


def format_call_block(sampleinfo: list[str], probs: np.ndarray,
                      kmer: np.ndarray) -> str:
    """call_mods rows (joined, newline-terminated) from decoded info
    columns, (n, 2) probabilities and k-mer codes; the same text as
    utils.formats.format_call_rows."""
    lib = native.load()
    n, L = kmer.shape
    if probs.shape != (n, 2) or len(sampleinfo) != n:
        raise ValueError(f"{len(sampleinfo)} rows, k-mers {kmer.shape}, "
                         f"probabilities {probs.shape}")
    probs = np.ascontiguousarray(probs, dtype=np.float32)
    kmer = np.ascontiguousarray(kmer, dtype=np.int32)
    out = np.empty(n * 40, dtype=np.uint8)
    lens = np.empty(n, dtype=np.int32)
    total = lib.dsp_format_call_suffixes(probs, kmer, n, L, out, lens)
    suffixes = out[:total].tobytes().decode("ascii")
    parts: list[str] = []
    pos = 0
    for i, info in enumerate(sampleinfo):
        end = pos + int(lens[i])
        parts.append(info)
        parts.append(suffixes[pos:end])
        pos = end
    return "".join(parts)
