"""Text codecs of extract, call_mods and call_freq, and the .npz feature
containers (copy of deepsignal_plant_tpu/utils/formats.py:26-122,
:124-340 and :344-425).

- features TSV, 12 columns (extract_features.py:381-395):
    chrom, pos, strand, pos_in_strand, readname, read_strand, kmer,
    means(csv 6dp), stds(csv 6dp), lens(csv int), signals(';'-rows of csv 6dp),
    methy_label
- call_mods TSV, 10 columns (call_modifications.py:176-188):
    chrom, pos, strand, pos_in_strand, readname, read_strand,
    prob_0(6dp), prob_1(6dp), called_label, center-5mer
- freq TSV, 11 columns / bedMethyl, 11 columns (call_mods_freq.py:100-118)
- .npz containers, one batch a file: v1 (``save_feature_npz``: float32
  arrays and the info columns as strings; training, tools and the
  per-site call_mods route), v2 (``save_wire_npz``: the float16 wire per
  site and an info byte blob), v3 (``save_packed_npz``: the read-packed
  wire). ``wire_npz_version`` tells them apart.
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


def format_feature_row(chrom: str, pos: int, strand: str, pos_in_strand: int,
                       readname: str, read_strand: str, kmer: str,
                       signal_means, signal_stds, signal_lens,
                       signals_rect, methy_label: int) -> str:
    """One features-TSV row, byte-identical to _features_to_str
    (extract_features.py:381): means/stds rounded to 6dp with shortest-repr
    float printing, signal matrix rows joined by ';'."""
    means_text = ",".join(str(x) for x in np.around(signal_means, 6).tolist())
    stds_text = ",".join(str(x) for x in np.around(signal_stds, 6).tolist())
    lens_text = ",".join(str(int(x)) for x in signal_lens)
    sig_text = ";".join(
        ",".join(str(y) for y in row) for row in signals_rect)
    return "\t".join([chrom, str(pos), strand, str(pos_in_strand), readname,
                      read_strand, kmer, means_text, stds_text, lens_text,
                      sig_text, str(methy_label)])


def save_feature_npz(path, fb: FeatureBatch, compress: bool = False
                     ) -> None:
    """The v1 feature container (training, tools, the per-site call_mods
    route): one .npz per batch, compact dtypes on disk, float values
    exact (float32). Uncompressed by default: inflating would bound the
    plane far below the device rate."""
    save = np.savez_compressed if compress else np.savez
    save(path,
         sampleinfo=np.array(fb.sampleinfo, dtype=np.bytes_),
         kmer=fb.kmer.astype(np.int8),
         base_means=fb.base_means.astype(np.float32),
         base_stds=fb.base_stds.astype(np.float32),
         base_signal_lens=fb.base_signal_lens.astype(np.int32),
         signals=fb.signals.astype(np.float32),
         labels=fb.labels.astype(np.int8))


def load_feature_npz(path) -> FeatureBatch:
    """A v1 container as a float32 FeatureBatch; a wire container (v2,
    v3) raises: training and the tools need v1."""
    z = _read_npz_arrays(path)
    if "sampleinfo" not in z:
        ver = int(z["wire_version"]) if "wire_version" in z else "?"
        raise ValueError(
            f"{path} is a wire-format (v{ver}) inference container; "
            "training and tools need the v1 container "
            "(save_feature_npz / extract --w_format npz)")
    return FeatureBatch(
        [s.decode() for s in z["sampleinfo"]],
        z["kmer"].astype(np.int32),
        z["base_means"].astype(np.float32),
        z["base_stds"].astype(np.float32),
        z["base_signal_lens"].astype(np.float32),
        z["signals"].astype(np.float32),
        z["labels"].astype(np.int32))


def save_wire_npz(path, fb: FeatureBatch) -> None:
    """The v2 container: the float16 wire per site (int8 base codes,
    halves) and the info columns as one byte blob with per-row offsets;
    it loads into a fastparse.RawFeatureBlock with no parsing."""
    infos = [s.encode() for s in fb.sampleinfo]
    lens = np.fromiter((len(b) for b in infos), np.int64, len(infos))
    row_starts = np.zeros(len(infos), np.int64)
    if len(infos) > 1:
        np.cumsum(lens[:-1], out=row_starts[1:])
    np.savez(path,
             wire_version=np.uint8(2),
             info_blob=np.frombuffer(b"".join(infos), np.uint8),
             row_starts=row_starts,
             info_ends=row_starts + lens,
             kmer=fb.kmer.astype(np.int8),
             base_means=fb.base_means.astype(np.float16),
             base_stds=fb.base_stds.astype(np.float16),
             base_signal_lens=fb.base_signal_lens.astype(np.float16),
             signals=fb.signals.astype(np.float16),
             labels=fb.labels.astype(np.int32))


def _read_npz_arrays(path) -> dict[str, np.ndarray]:
    """Every member of an .npz as an array, by raw zip member reads and
    np.frombuffer (read-only views over the member bytes). The JAX
    package measured np.load collapsing ~4x under a thread pool; this
    reads twice as fast on one thread. A member in a .npy version other
    than 1.0 or 2.0 goes through np.lib.format.read_array."""
    import zipfile
    from io import BytesIO
    fmt = np.lib.format
    out: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if not name.endswith(".npy"):
                continue
            raw = z.read(name)
            bio = BytesIO(raw)
            version = fmt.read_magic(bio)
            if version not in ((1, 0), (2, 0)):
                bio.seek(0)
                out[name[:-4]] = fmt.read_array(bio, allow_pickle=False)
                continue
            shape, fortran, dtype = (
                fmt.read_array_header_1_0(bio) if version == (1, 0)
                else fmt.read_array_header_2_0(bio))
            if dtype.hasobject:
                raise ValueError(f"{path}: object array member {name}")
            arr = np.frombuffer(raw, dtype=dtype,
                                count=int(np.prod(shape, dtype=np.int64)),
                                offset=bio.tell())
            out[name[:-4]] = arr.reshape(shape,
                                         order="F" if fortran else "C")
    return out


def _check_version(path, z: dict, want: int) -> None:
    ver = int(z["wire_version"])
    if ver != want:
        raise ValueError(
            f"{path} is wire-format v{ver}, not v{want} — a directory "
            "must not mix wire versions (regenerate with one extract "
            "--w_format)")


def load_wire_npz(path):
    """A v2 container as a fastparse.RawFeatureBlock."""
    from .fastparse import RawFeatureBlock
    z = _read_npz_arrays(path)
    _check_version(path, z, 2)
    return RawFeatureBlock(
        z["info_blob"].tobytes(), z["row_starts"], z["info_ends"],
        z["kmer"], z["base_means"], z["base_stds"],
        z["base_signal_lens"], z["signals"],
        z["labels"].astype(np.int32))


def is_wire_npz(path) -> bool:
    """Whether an .npz is a wire container (v2 or v3): a read of the zip
    directory only."""
    import zipfile
    try:
        with zipfile.ZipFile(path) as zf:
            return "wire_version.npy" in zf.namelist()
    except (zipfile.BadZipFile, OSError):
        return False


def wire_npz_version(path) -> int:
    """0 = v1 (plain feature arrays), 2 = per-site wire, 3 = read-packed
    wire. Reads only the version member."""
    import zipfile
    from io import BytesIO
    try:
        with zipfile.ZipFile(path) as zf:
            if "wire_version.npy" not in zf.namelist():
                return 0
            bio = BytesIO(zf.read("wire_version.npy"))
            return int(np.lib.format.read_array(bio))
    except zipfile.BadZipFile:
        return 0


def save_packed_npz(path, pb) -> None:
    """A read-packed wire block (fastparse.PackedFeatureBlock) as the v3
    container: deduplicated per-base arrays, per-site window centres and
    the info columns' bytes (v2's blob layout)."""
    np.savez(path,
             wire_version=np.uint8(3),
             kmer_len=np.int32(pb.kmer_len),
             info_blob=np.frombuffer(pb.raw, np.uint8),
             row_starts=pb.row_starts.astype(np.int64),
             info_ends=pb.info_ends.astype(np.int64),
             centers=pb.centers.astype(np.int32),
             codes=pb.codes.astype(np.int8),
             base_means=pb.means.astype(np.float16),
             base_stds=pb.stds.astype(np.float16),
             base_signal_lens=pb.lens.astype(np.float16),
             signals=pb.rect.astype(np.float16),
             labels=pb.labels.astype(np.int32))


def load_packed_npz(path):
    """A v3 container as a fastparse.PackedFeatureBlock; raises on another
    version or window centres outside the base axis."""
    from .fastparse import PackedFeatureBlock
    z = _read_npz_arrays(path)
    _check_version(path, z, 3)
    centers = z["centers"]
    kmer_len = int(z["kmer_len"])
    nb = (kmer_len - 1) // 2
    if len(centers) > 1 and np.any(np.diff(centers) < 0):
        raise ValueError(
            f"{path}: packed-wire centers are not non-decreasing")
    if len(centers) and (int(centers[0]) < nb or
                         int(centers[-1]) + nb >= len(z["codes"])):
        raise ValueError(
            f"{path}: packed-wire centers out of bounds for the base "
            "axis (corrupt or truncated container)")
    return PackedFeatureBlock(
        z["info_blob"].tobytes(), z["row_starts"], z["info_ends"],
        centers, z["codes"], z["base_means"], z["base_stds"],
        z["base_signal_lens"], z["signals"],
        z["labels"].astype(np.int32), kmer_len)


def feature_npz_paths(path: str) -> list[str] | None:
    """The sorted .npz files of ``path`` (an .npz file, or a directory
    holding .npz batches), or None."""
    import os
    if os.path.isfile(path) and path.endswith(".npz"):
        return [path]
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".npz"))
        if files:
            return files
    return None


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
