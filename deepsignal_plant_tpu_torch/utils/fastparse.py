"""Python side of the native codecs (native/featparse.cpp; copy of
deepsignal_plant_tpu/utils/fastparse.py:153-330 and :329-660, the parts
call_mods, extract, the dataset and call_freq call).

- ``parse_feature_bytes``: a newline-terminated byte block -> FeatureBatch
  (float32, or the float16 wire: int8 codes, IEEE halves);
- ``parse_raw_feature_block``: the float16 wire plus byte spans of each
  row's 6 info columns, with no per-row Python string;
- ``pack_raw_block``: the read-packed wire (deduplicated per-base arrays
  and int32 window centres) rebuilt from parsed rows;
- ``emit_call_rows_arrays`` and ``format_call_block``: call_mods rows;
- ``parse_call_bytes``: call_mods rows -> CallBlock (call_freq's input);
- ``quantize_int8``: the int8 wire's symmetric per-array quantization;
- extraction: ``extract_norm_stats`` (one read's normalization, segment
  statistics and float16 rect in one pass), the compat mode's
  ``normalize_mad_native``, ``segment_stats_exact_native``,
  ``build_rect_compat`` and ``compat_sampler``, ``build_rect_f16``,
  ``format_info_rows`` and ``format_feature_cols``. These return None on
  a corrupt event table: extract.py then runs its numpy chain, as the
  JAX package does.

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


def quantize_int8(arr: np.ndarray, portable: bool = False
                  ) -> tuple[np.ndarray, float]:
    """Symmetric int8 quantization of a float16 or float32 array
    (dsp_quantize_i8_f16 / _f32; JAX utils/fastparse.py:91): (int8 array,
    dequant scale amax/127, 1.0 for all-zero or empty input), round half
    even, NaN to 0. ``portable`` runs the float16 loop without AVX-512.
    Raises on another dtype; there is no numpy path."""
    a = np.ascontiguousarray(arr)
    if a.dtype not in (np.float16, np.float32):
        raise TypeError(f"quantize_int8 takes float16 or float32, not "
                        f"{a.dtype}")
    lib = native.load()
    out = np.empty(a.shape, np.int8)
    if a.dtype == np.float16:
        fn = (lib.dsp_quantize_i8_f16_portable if portable
              else lib.dsp_quantize_i8_f16)
        s = fn(a.reshape(-1).view(np.uint16), a.size, out.reshape(-1))
    else:
        s = lib.dsp_quantize_i8_f32(a.reshape(-1), a.size, out.reshape(-1))
    return out, float(s)


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


# ---------------------------------------------------------------------------
# extraction (pipeline/extract.py; JAX utils/fastparse.py:153-330, :636)
# ---------------------------------------------------------------------------

def _event_table(norm_len: int, starts: np.ndarray, lengths: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray] | None:
    """The event table as contiguous int64, or None when a segment is
    negative or runs past the signal: the C loops index unchecked, so a
    corrupt table takes the numpy chain, which clips."""
    starts = np.ascontiguousarray(starts, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    if len(starts) and (int(lengths.min()) < 0 or int(starts.min()) < 0
                        or int((starts + lengths).max()) > norm_len):
        return None
    return starts, lengths


class CompatSampler:
    """A CPython-``random.Random``-compatible MT19937 sampler in the
    native library (dsp_mt_seed / dsp_mt_sample_sorted). From the same
    int seed it consumes the same stream as ``random.Random`` and its
    ``sample()`` returns the same picks, sorted, so compat-mode
    extraction gives the same bytes whichever side draws."""

    __slots__ = ("_lib", "state")

    def __init__(self, lib, seed: int):
        self._lib = lib
        self.state = np.zeros(625, np.uint32)
        n = abs(int(seed))
        words = []
        while n:
            words.append(n & 0xFFFFFFFF)
            n >>= 32
        key = np.array(words or [0], np.uint32)
        lib.dsp_mt_seed(self.state, key, len(key))

    def sample(self, population, k: int) -> list:
        """random.sample(range(n), k), sorted. ``population`` must be a
        range starting at 0 (compat mode passes ``range(event_length)``)."""
        n = len(population)
        out = np.empty(k, np.int64)
        if self._lib.dsp_mt_sample_sorted(self.state, n, k, out) != 0:
            raise ValueError(f"sample({n}, {k}) invalid")
        return out.tolist()


def compat_sampler(seed: int) -> CompatSampler:
    return CompatSampler(native.load(), seed)


def normalize_mad_native(signal: np.ndarray) -> np.ndarray | None:
    """MAD normalization + 6-decimal rounding, equal bit for bit to
    pipeline.extract.normalize_signals(method="mad"); None for an empty
    signal."""
    lib = native.load()
    signal = np.ascontiguousarray(signal, np.float64)
    if len(signal) == 0:
        return None
    norm = np.empty(len(signal), np.float64)
    if lib.dsp_normalize_mad(signal, len(signal), norm) != 0:
        return None
    return norm


def segment_stats_exact_native(norm: np.ndarray, starts: np.ndarray,
                               lengths: np.ndarray
                               ) -> tuple[np.ndarray, np.ndarray] | None:
    """np.mean/np.std per event in numpy's pairwise-summation order
    (compat mode; reference extract_features.py:364-365), or None for an
    empty or corrupt event table."""
    lib = native.load()
    norm = np.ascontiguousarray(norm, np.float64)
    ev = _event_table(len(norm), starts, lengths)
    if ev is None or len(ev[0]) == 0:
        return None
    nb = len(ev[0])
    means = np.empty(nb, np.float64)
    stds = np.empty(nb, np.float64)
    if lib.dsp_segment_stats_exact(norm, *ev, nb, means, stds) != 0:
        return None
    return means, stds


def build_rect_compat(norm: np.ndarray, starts: np.ndarray,
                      lengths: np.ndarray, signal_len: int,
                      sampler: CompatSampler) -> np.ndarray | None:
    """build_signal_rect("compat"): short events centre-zero-padded, long
    ones downsampled by sorted random.sample picks from ``sampler``'s
    stream in ascending row order. The (n, signal_len) float64 rect, or
    None for a corrupt event table."""
    lib = native.load()
    norm = np.ascontiguousarray(norm, np.float64)
    ev = _event_table(len(norm), starts, lengths)
    if ev is None:
        return None
    nb = len(ev[0])
    rect = np.empty((nb, signal_len), np.float64)
    if lib.dsp_rect_compat(norm, *ev, nb, signal_len, sampler.state,
                           rect) != 0:
        return None
    return rect


def build_rect_f16(norm: np.ndarray, starts: np.ndarray,
                   lengths: np.ndarray, signal_len: int
                   ) -> np.ndarray | None:
    """The "even" signal rect straight to float16, or None for a corrupt
    event table."""
    lib = native.load()
    norm = np.ascontiguousarray(norm, np.float64)
    ev = _event_table(len(norm), starts, lengths)
    if ev is None:
        return None
    rect = np.empty((len(ev[0]), signal_len), np.float16)
    lib.dsp_build_rect_f16(norm, *ev, len(ev[0]), signal_len,
                           rect.reshape(-1).view(np.uint16))
    return rect


def extract_norm_stats(signal: np.ndarray, starts: np.ndarray,
                       lengths: np.ndarray, signal_len: int,
                       want_rect: bool = True) -> dict | None:
    """One read's MAD normalization, 6-decimal rounding, per-event
    mean/std (cumulative-sum semantics), float16 rect and the packed
    wire's rounded float16 means/stds/lens in one C pass
    (dsp_read_norm_stats), equal bit for bit to pipeline.extract's
    normalize_signals -> segment_stats -> build_signal_rect("even").
    None for an empty signal or an empty or corrupt event table."""
    lib = native.load()
    signal = np.ascontiguousarray(signal, np.float64)
    ns = len(signal)
    ev = _event_table(ns, starts, lengths)
    if ns == 0 or ev is None or len(ev[0]) == 0:
        return None
    nb = len(ev[0])
    norm = np.empty(ns, np.float64)
    means64 = np.empty(nb, np.float64)
    stds64 = np.empty(nb, np.float64)
    means16 = np.empty(nb, np.float16)
    stds16 = np.empty(nb, np.float16)
    lens16 = np.empty(nb, np.float16)
    # S = 0 skips the rect (the TSV writer rebuilds it in float64)
    S = signal_len if want_rect else 0
    rect16 = np.empty((nb, S), np.float16)
    if lib.dsp_read_norm_stats(
            signal, ns, *ev, nb, S, norm, means64, stds64,
            means16.view(np.uint16), stds16.view(np.uint16),
            lens16.view(np.uint16), rect16.reshape(-1).view(np.uint16)):
        return None
    out = {"norm": norm, "means": means64, "stds": stds64,
           "means16": means16, "stds16": stds16, "lens16": lens16}
    if want_rect:
        out["rect16"] = rect16
    return out


def format_info_rows(chrom: str, strand: str, readname: str,
                     read_strand: str, pos: np.ndarray, pis: np.ndarray
                     ) -> tuple[bytes, np.ndarray]:
    """One read's per-site info columns
    ``chrom\\tpos\\tstrand\\tpos_in_strand\\treadname\\tread_strand``:
    (concatenated bytes, per-row byte lengths)."""
    lib = native.load()
    n = len(pos)
    cb, sb = chrom.encode(), strand.encode()
    rb_, rsb = readname.encode(), read_strand.encode()
    pos = np.ascontiguousarray(pos, np.int64)
    pis = np.ascontiguousarray(pis, np.int64)
    cap = n * (len(cb) + len(sb) + len(rb_) + len(rsb) + 47)
    out = np.empty(cap, np.uint8)
    row_lens = np.empty(n, np.int64)
    total = lib.dsp_format_info_rows(cb, len(cb), sb, len(sb), rb_,
                                     len(rb_), rsb, len(rsb), pos, pis, n,
                                     out, row_lens)
    return out[:total].tobytes(), row_lens


def format_feature_cols(means: np.ndarray, stds: np.ndarray,
                        lens: np.ndarray, rect: np.ndarray) -> list[str]:
    """Feature columns 7-10 of each site as text (means/stds/lens csv and
    the ';'-joined rect), equal to np.around(..., 6) + str, -0.0
    included."""
    lib = native.load()
    n, L = means.shape
    S = rect.shape[2]
    means = np.ascontiguousarray(means, np.float64)
    stds = np.ascontiguousarray(stds, np.float64)
    lens = np.ascontiguousarray(lens, np.int32)
    rect = np.ascontiguousarray(rect, np.float64)
    # 32 bytes a value covers the widest fixed-point and %g outputs
    out = np.empty(n * (3 * L * 32 + L * S * 32), np.uint8)
    out_lens = np.empty(n, np.int32)
    total = lib.dsp_format_feature_cols(means, stds, lens, rect, n, L, S,
                                        out, out_lens)
    text = out[:total].tobytes().decode("ascii")
    cols = []
    pos = 0
    for i in range(n):
        end = pos + int(out_lens[i])
        cols.append(text[pos:end])
        pos = end
    return cols
