"""extract — per-site feature extraction from tombo-resquiggled fast5s
into a features TSV or a directory of .npz feature batches (counterpart
of deepsignal_plant_tpu/pipeline/extract.py:41-930), and the fused
fast5 -> call_mods path (its :932-1205).

Reference behavior (extract_features.py:277-378,589-651): per read,
rescale + normalize the raw signal, rebuild the genome-aligned sequence and
per-base signal segments from the event table, scan for motif hits, and for
each centered site emit a 12-column feature row. Process topology: a pool
of worker processes over fast5 batches; the main process only joins what
the workers wrote.

The per-base work is vectorized (float64 cumulative sums over the event
table, one gathered (n_bases, signal_len) signal matrix) and runs in the
port's native library where the JAX package's does
(utils/fastparse.py), branch for branch: ``mad`` + ``even`` takes
dsp_read_norm_stats, ``mad`` + ``compat`` the native compat chain,
``zscore`` and corrupt event tables the numpy chain.

Fast5s are read by the port's own HDF5 reader (io/fast5.py): no h5py.

Workers are spawned (the parent may hold a CUDA context) and import only
this module and host modules: nothing here imports torch at import time.
Arrays never cross the executor's result pipe (the JAX package measured
it at ~15 MB/s): workers write part files and return counts. Output is
joined in fast5-batch order, so its bytes do not depend on ``nproc`` or
on which worker finishes first. ``--w_format npz|npz_wire|npz_packed``
writes one ``<batch index>.npz`` per fast5 batch (the v1, v2 and v3
containers of utils/formats.py), so the files hold the same arrays at
every ``nproc``; pooled workers save theirs through a dot-temp name and
a rename, and a killed worker leaves no half-written ``.npz``.
"""
from __future__ import annotations

import contextlib
import os
import random
import shutil
import tempfile
import time
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import dataclass, replace as dc_replace

import numpy as np

from ..io.fast5 import (MultiReadFast5Error, TomboRead, VBZPluginError,
                        read_tombo_fast5)
from ..parallel.dist import host_output_path, shard_for_host
from ..utils.bases import seq_to_codes, str2bool
from ..utils.fasta import get_contig2len
from ..utils.fileio import get_fast5s
from ..utils.formats import (FeatureBatch, gzip_path, load_feature_npz,
                             load_packed_npz, save_feature_npz,
                             save_packed_npz, save_wire_npz)
from ..utils.motifs import (PositionIndex, expand_motifs,
                            motif_locs_in_codes, parse_region)

# MAD consistency constant: Gaussian.ppf(3/4), the statsmodels robust.mad
# default the reference relies on (extract_features.py:183)
_MAD_C = 0.6744897501960817

#: --w_format -> the saver of its .npz container (utils/formats.py)
NPZ_SAVERS = {"npz": save_feature_npz, "npz_wire": save_wire_npz,
              "npz_packed": save_packed_npz}


def normalize_signals(signals: np.ndarray, method: str = "mad") -> np.ndarray:
    """Read-level normalization, rounded to 6 decimals
    (extract_features.py:179-190)."""
    signals = np.asarray(signals, dtype=np.float64)
    if method == "zscore":
        shift, scale = np.mean(signals), float(np.std(signals))
    elif method == "mad":
        med = np.median(signals)
        shift, scale = med, float(np.median(np.abs(signals - med)) / _MAD_C)
    else:
        raise ValueError("normalize_method must be mad or zscore")
    if scale == 0.0:
        norm = signals
    else:
        norm = (signals - shift) / scale
    return np.around(norm, decimals=6)


def segment_stats(norm: np.ndarray, starts: np.ndarray, lengths: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-event mean/std over ``norm`` segments [start, start+length) via
    float64 cumulative sums."""
    cs = np.concatenate([[0.0], np.cumsum(norm, dtype=np.float64)])
    cs2 = np.concatenate([[0.0], np.cumsum(norm * norm, dtype=np.float64)])
    ends = starts + lengths
    sums = cs[ends] - cs[starts]
    sums2 = cs2[ends] - cs2[starts]
    n = np.maximum(lengths, 1).astype(np.float64)
    means = sums / n
    var = np.maximum(sums2 / n - means * means, 0.0)
    return means, np.sqrt(var)


def segment_stats_exact(norm: np.ndarray, starts: np.ndarray,
                        lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """np.mean/np.std per segment (pairwise summation), the reference's
    numerics (extract_features.py:364-365); "compat" mode."""
    means = np.empty(len(starts), np.float64)
    stds = np.empty(len(starts), np.float64)
    for i in range(len(starts)):
        seg = norm[starts[i]:starts[i] + lengths[i]]
        means[i] = np.mean(seg)
        stds[i] = np.std(seg)
    return means, stds


def build_signal_rect(norm: np.ndarray, starts: np.ndarray,
                      lengths: np.ndarray, signal_len: int,
                      downsample: str = "even",
                      rng: random.Random | None = None) -> np.ndarray:
    """(n_bases, signal_len) matrix: center-zero-padded when a base has
    fewer samples, downsampled (order-preserving) when it has more
    (extract_features.py:232-251).

    "even": deterministic evenly-spaced downsampling. "compat": the
    reference's sorted random sample.
    """
    n = len(starts)
    S = signal_len
    rel = np.arange(S)[None, :]                       # (1, S)
    lens = lengths[:, None]                           # (n, 1)
    st = starts[:, None]

    if downsample == "even":
        long_idx = st + (rel * lens) // S
    elif downsample == "compat":
        rng = rng or random
        from ..utils.fastparse import CompatSampler, build_rect_compat
        if isinstance(rng, CompatSampler):
            # the native whole-read rect on the same MT stream; None on
            # a corrupt event table, which the loop below handles
            r = build_rect_compat(norm, starts, lengths, S, rng)
            if r is not None:
                return r
        long_idx = np.empty((n, S), dtype=np.int64)
        long_rows = np.nonzero(lengths > S)[0]
        for i in long_rows:
            picks = sorted(rng.sample(range(int(lengths[i])), S))
            long_idx[i] = starts[i] + np.asarray(picks)
        short_rows = lengths <= S
        long_idx[short_rows] = (st + (rel * lens) // S)[short_rows]
    else:
        raise ValueError("downsample must be 'even' or 'compat'")

    pad_left = (S - lens) // 2                        # (n, 1), for short rows
    k = rel - pad_left
    short_valid = (k >= 0) & (k < lens)
    short_idx = st + np.clip(k, 0, np.maximum(lens - 1, 0))

    is_long = lens > S
    idx = np.where(is_long, long_idx, short_idx)
    mask = np.where(is_long, True, short_valid)
    # np.where (not multiply): pad slots must be +0.0, never -0.0
    rect = np.where(mask, norm[np.clip(idx, 0, len(norm) - 1)], 0.0)
    return rect


@dataclass
class ExtractOptions:
    corrected_group: str = "RawGenomeCorrected_000"
    basecall_subgroup: str = "BaseCalled_template"
    normalize_method: str = "mad"
    motifs: str = "CG"
    mod_loc: int = 0
    kmer_len: int = 13
    signal_len: int = 16
    methy_label: int = 1
    positions: str | None = None          # path to positions file
    region: str | None = None
    reference_path: str | None = None
    downsample: str = "even"
    # the float16 plane of call_mods sets this: its blocks are
    # read-packed, and with "even" downsampling the rect is built
    # natively straight to float16 (the same round-to-nearest-even as
    # numpy's astype)
    rect_f16: bool = False


@dataclass
class ExtractContext:
    """Pre-resolved, worker-shareable state (reference _extract_preprocess_,
    extract_features.py:532-553)."""
    motif_seqs: list[str]
    chrom2len: dict | None
    positions: PositionIndex | None
    regioninfo: tuple
    opts: ExtractOptions

    @classmethod
    def build(cls, opts: ExtractOptions, is_dna: bool = True
              ) -> "ExtractContext":
        if opts.kmer_len % 2 == 0:
            raise ValueError("kmer_len must be odd")
        motif_seqs = expand_motifs(opts.motifs, is_dna)
        chrom2len = (get_contig2len(opts.reference_path)
                     if opts.reference_path else None)
        positions = (PositionIndex(opts.positions)
                     if opts.positions else None)
        regioninfo = parse_region(opts.region)
        return cls(motif_seqs, chrom2len, positions, regioninfo, opts)


def extract_read_features(read: TomboRead, ctx: ExtractContext,
                          rng: random.Random | None = None):
    """All feature rows of one read as struct-of-arrays, or None if the read
    is filtered out. Site semantics parity: extract_features.py:296-372."""
    opts = ctx.opts
    rg_chrom, rg_start, rg_end = ctx.regioninfo
    if rg_chrom is not None and rg_chrom != read.chrom:
        return None

    seq = read.seq
    L = len(seq)
    read_rg_start = read.chrom_start if rg_start is None else rg_start
    read_rg_end = read.chrom_start + L if rg_end is None else rg_end
    if read_rg_start >= read.chrom_start + L or \
            read_rg_end <= read.chrom_start:
        return None

    chromlen = None
    if ctx.chrom2len is not None:
        chromlen = ctx.chrom2len.get(read.chrom)
        if chromlen is None:
            print("warning - chrom_name in fast5 not in provided reference "
                  "genome!")

    seq_bytes = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    locs = motif_locs_in_codes(seq_bytes, ctx.motif_seqs, opts.mod_loc)
    nb = (opts.kmer_len - 1) // 2
    locs = locs[(locs >= nb) & (locs < L - nb)]
    if len(locs) == 0:
        return None

    if read.alignstrand == "-":
        pos = read.chrom_start + L - 1 - locs
    else:
        pos = read.chrom_start + locs
    if chromlen is not None:
        pos_in_strand = (chromlen - 1 - pos if read.alignstrand == "-"
                         else pos)
    else:
        pos_in_strand = np.full_like(pos, -1)

    keep = np.ones(len(locs), dtype=bool)
    if rg_chrom is not None:
        keep &= (pos >= read_rg_start) & (pos < read_rg_end)
    if ctx.positions is not None:
        keep &= ctx.positions.mask(read.chrom, read.alignstrand, pos)
    locs, pos, pos_in_strand = locs[keep], pos[keep], pos_in_strand[keep]
    if len(locs) == 0:
        return None

    # the native chains return None on an empty or corrupt event table;
    # the numpy chain (which clips) then runs, as in the JAX package
    from ..utils.fastparse import (build_rect_f16, extract_norm_stats,
                                   normalize_mad_native,
                                   segment_stats_exact_native)
    f16pre = None
    nres = None
    if opts.normalize_method == "mad" and opts.downsample == "even":
        nres = extract_norm_stats(read.raw_signal, read.event_starts,
                                  read.event_lengths, opts.signal_len,
                                  want_rect=opts.rect_f16)
    if nres is not None:
        norm, means, stds = nres["norm"], nres["means"], nres["stds"]
        if opts.rect_f16:
            rect = nres["rect16"]
            f16pre = (nres["means16"], nres["stds16"], nres["lens16"])
        else:
            rect = build_signal_rect(norm, read.event_starts,
                                     read.event_lengths, opts.signal_len,
                                     opts.downsample, rng)
    elif opts.normalize_method == "mad" and opts.downsample == "compat":
        norm = normalize_mad_native(read.raw_signal)
        if norm is None:
            norm = normalize_signals(read.raw_signal, "mad")
        nstats = segment_stats_exact_native(norm, read.event_starts,
                                            read.event_lengths)
        if nstats is not None:
            means, stds = nstats
        else:
            means, stds = segment_stats_exact(norm, read.event_starts,
                                              read.event_lengths)
        rect = build_signal_rect(norm, read.event_starts,
                                 read.event_lengths, opts.signal_len,
                                 "compat", rng)
    else:
        norm = normalize_signals(read.raw_signal, opts.normalize_method)
        stats_fn = (segment_stats_exact if opts.downsample == "compat"
                    else segment_stats)
        means, stds = stats_fn(norm, read.event_starts,
                               read.event_lengths)
        rect = None
        if opts.rect_f16 and opts.downsample == "even":
            rect = build_rect_f16(norm, read.event_starts,
                                  read.event_lengths, opts.signal_len)
        if rect is None:
            rect = build_signal_rect(norm, read.event_starts,
                                     read.event_lengths, opts.signal_len,
                                     opts.downsample, rng)

    # per-read arrays + site locs; the k-mer windows are gathered lazily
    # (windowize_features) or on the card by the read-packed route
    return {
        "chrom": read.chrom, "strand": read.alignstrand,
        "readname": read.readname, "read_strand": read.read_strand,
        "pos": pos, "pos_in_strand": pos_in_strand,
        "locs": locs, "seq": seq, "kmer_len": opts.kmer_len,
        "r_means": means, "r_stds": stds,
        "r_lens": read.event_lengths, "r_rect": rect,
        # (means16, stds16, lens16) when the native kernel already
        # rounded and cast them for the packed wire, else None
        "r_f16": f16pre,
        "label": opts.methy_label,
    }


def windowize_features(feats: dict) -> dict:
    """Materialize the per-site kmer windows of one read's features
    (extract_features.py:296-372's per-site view of the read arrays)."""
    if "means" in feats:
        return feats
    locs, seq = feats["locs"], feats["seq"]
    nb = (feats["kmer_len"] - 1) // 2
    win = locs[:, None] + np.arange(-nb, nb + 1)[None, :]   # (n, k)
    return {**feats,
            "kmers": [seq[lo - nb:lo + nb + 1] for lo in locs],
            "means": feats["r_means"][win], "stds": feats["r_stds"][win],
            "lens": feats["r_lens"][win], "rect": feats["r_rect"][win]}


def features_to_rows(feats: dict) -> list[str]:
    """One read's features as TSV rows (extract_features.py:381), columns
    7-10 formatted natively."""
    from ..utils.fastparse import format_feature_cols

    feats = windowize_features(feats)
    n = len(feats["pos"])
    cols = format_feature_cols(feats["means"], feats["stds"],
                               feats["lens"], feats["rect"])
    label = str(feats["label"])
    chrom, strand = feats["chrom"], feats["strand"]
    readname, read_strand = feats["readname"], feats["read_strand"]
    return ["\t".join([chrom, str(int(feats["pos"][i])), strand,
                       str(int(feats["pos_in_strand"][i])), readname,
                       read_strand, feats["kmers"][i], cols[i], label])
            for i in range(n)]


def features_to_batch(feats_list: list[dict], kmer_len: int,
                      signal_len: int) -> FeatureBatch:
    """Reads' features as model-ready float32 arrays (the fused path's
    per-site route), with the on-disk 6-decimal rounding of means and
    stds so the fused and the TSV planes feed the model the same
    values."""
    sampleinfo: list[str] = []
    kmers, means, stds, lens, rects, labels = [], [], [], [], [], []
    for f in feats_list:
        f = windowize_features(f)
        n = len(f["pos"])
        for i in range(n):
            sampleinfo.append("\t".join([
                f["chrom"], str(int(f["pos"][i])), f["strand"],
                str(int(f["pos_in_strand"][i])), f["readname"],
                f["read_strand"]]))
        kmers.append(np.stack([seq_to_codes(k) for k in f["kmers"]]))
        means.append(np.around(f["means"], 6))
        stds.append(np.around(f["stds"], 6))
        lens.append(f["lens"])
        rects.append(f["rect"])
        labels.append(np.full(n, f["label"], dtype=np.int32))
    return FeatureBatch(
        sampleinfo,
        np.concatenate(kmers).astype(np.int32),
        np.concatenate(means).astype(np.float32),
        np.concatenate(stds).astype(np.float32),
        np.concatenate(lens).astype(np.float32),
        np.concatenate(rects).astype(np.float32),
        np.concatenate(labels))


def features_to_packed(feats_list: list[dict]):
    """Reads' features as a read-packed wire block
    (fastparse.PackedFeatureBlock): per-base arrays concatenated across
    reads + per-site window centers; the k-mer gather happens on the
    card."""
    from ..utils.fastparse import PackedFeatureBlock, format_info_rows

    info_blobs: list[bytes] = []
    info_lens_l: list[np.ndarray] = []
    centers_l, labels_l = [], []
    codes_l, means_l, stds_l, lens_l, rect_l = [], [], [], [], []
    base_off = 0
    kmer_len = feats_list[0]["kmer_len"]
    for f in feats_list:
        n = len(f["pos"])
        blob, rlens = format_info_rows(f["chrom"], f["strand"],
                                       f["readname"], f["read_strand"],
                                       f["pos"], f["pos_in_strand"])
        info_blobs.append(blob)
        info_lens_l.append(rlens)
        centers_l.append(f["locs"].astype(np.int64) + base_off)
        labels_l.append(np.full(n, f["label"], np.int32))
        codes_l.append(seq_to_codes(f["seq"]).astype(np.int8))
        # the on-disk 6-decimal rounding (features_to_batch does the same
        # on its windowed view); the native kernel pre-fused it when it ran
        if f.get("r_f16") is not None:
            m16, s16, l16 = f["r_f16"]
            means_l.append(m16)
            stds_l.append(s16)
            lens_l.append(l16)
        else:
            means_l.append(np.around(f["r_means"], 6).astype(np.float16))
            stds_l.append(np.around(f["r_stds"], 6).astype(np.float16))
            lens_l.append(f["r_lens"].astype(np.float16))
        rect_l.append(np.asarray(f["r_rect"], np.float16))
        base_off += len(f["seq"])
    lens_b = np.concatenate(info_lens_l)
    n_rows = len(lens_b)
    row_starts = np.zeros(n_rows, np.int64)
    if n_rows > 1:
        np.cumsum(lens_b[:-1], out=row_starts[1:])
    return PackedFeatureBlock(
        b"".join(info_blobs), row_starts, row_starts + lens_b,
        np.concatenate(centers_l).astype(np.int32),
        np.concatenate(codes_l), np.concatenate(means_l),
        np.concatenate(stds_l), np.concatenate(lens_l),
        np.concatenate(rect_l), np.concatenate(labels_l), kmer_len)


# ---------------------------------------------------------------------------
# process-pool pipeline
# ---------------------------------------------------------------------------

_G_CTX: ExtractContext | None = None
_G_SEED: int | None = None
# pooled-run sink spec: workers write their own output (TSV part files
# or part .npz files) and return counts
_G_SINK: tuple | None = None


def _init_worker(ctx: ExtractContext, seed: int | None,
                 sink: tuple | None = None):
    global _G_CTX, _G_SEED, _G_SINK
    _G_CTX = ctx
    _G_SEED = seed
    _G_SINK = sink


def _batch_rng(batch_idx: int):
    """Deterministic per-batch RNG of "compat" downsampling: keyed by the
    batch index, not the worker, so --seed reproduces the bytes across
    runs and pool layouts. The native CPython-compatible sampler (same
    stream, same picks as random.Random) lets the compat rect run in C."""
    from ..utils.fastparse import compat_sampler
    if _G_SEED is None:
        return compat_sampler(int.from_bytes(os.urandom(16), "little"))
    return compat_sampler(_G_SEED * 1_000_003 + batch_idx)


_warned_actionable = False


def _extract_batch_feats(paths: list[str], batch_idx: int = 0
                         ) -> tuple[list[dict], int]:
    global _warned_actionable
    ctx = _G_CTX
    rng = _batch_rng(batch_idx)
    feats_list: list[dict] = []
    errors = 0
    for p in paths:
        try:
            read = read_tombo_fast5(p, ctx.opts.corrected_group,
                                    ctx.opts.basecall_subgroup)
            if read is None:
                continue
            feats = extract_read_features(read, ctx, rng)
            if feats is not None:
                feats_list.append(feats)
        except (MultiReadFast5Error, VBZPluginError) as exc:
            # these failures have a user fix (convert a multi-read file;
            # for VBZ, install the system's libzstd.so.1, or convert a
            # VBZ version the port does not decode); say so once per
            # process instead of only counting them
            if not _warned_actionable:
                _warned_actionable = True
                print(f"[warn] {exc}")
            errors += 1
        except Exception:
            errors += 1
    return feats_list, errors


def _worker_rows(paths: list[str], batch_idx: int = 0
                 ) -> tuple[list[str], int]:
    feats_list, errors = _extract_batch_feats(paths, batch_idx)
    rows: list[str] = []
    for f in feats_list:
        rows.extend(features_to_rows(f))
    return rows, errors


def _worker_block(paths: list[str], batch_idx: int = 0):
    """One fast5 batch as a call_mods input block: a PackedFeatureBlock
    (float16 plane) or a FeatureBatch (float32), or None."""
    feats_list, errors = _extract_batch_feats(paths, batch_idx)
    if not feats_list:
        return None, errors
    opts = _G_CTX.opts
    if opts.rect_f16:
        return features_to_packed(feats_list), errors
    return features_to_batch(feats_list, opts.kmer_len,
                             opts.signal_len), errors


def part_path(part_dir: str, batch_idx: int) -> str:
    return os.path.join(part_dir, f"{batch_idx:06d}.part")


def _worker_rows_part(paths: list[str], batch_idx: int = 0
                      ) -> tuple[int, int]:
    """Pooled TSV worker: extract + format + write a part file (a gzip
    member when the output is gzip: concatenated members form one valid
    stream), returning only (n_rows, n_errors)."""
    part_dir, is_gzip = _G_SINK
    rows, errors = _worker_rows(paths, batch_idx)
    data = ("\n".join(rows) + "\n").encode() if rows else b""
    path = part_path(part_dir, batch_idx)
    if is_gzip:
        import gzip as _gzip
        with _gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        with open(path, "wb") as fh:
            fh.write(data)
    return len(rows), errors


def npz_batch_path(write_dir: str, batch_idx: int) -> str:
    return os.path.join(write_dir, f"{batch_idx:06d}.npz")


def _worker_batch_save(paths: list[str], batch_idx: int = 0
                       ) -> tuple[int, int]:
    """The .npz worker (JAX extract.py:665-700) of ``extract --w_format
    npz*`` and of the fused path's pool: extract one fast5 batch and
    save its container under the batch's index, returning only
    (n_sites, n_errors). The save goes through a dot-temp name that no
    directory reader picks up (it does not end in .npz) and a rename, so
    a worker killed mid-save leaves no truncated .npz."""
    write_dir, out_format = _G_SINK
    blk, errors = _worker_block(paths, batch_idx)
    n = 0 if blk is None else (blk.n if _G_CTX.opts.rect_f16 else len(blk))
    if n:
        tmp = os.path.join(write_dir, f".{batch_idx:06d}.npz.tmp")
        with open(tmp, "wb") as fh:
            NPZ_SAVERS[out_format](fh, blk)
        os.replace(tmp, npz_batch_path(write_dir, batch_idx))
    return n, errors


def _pool_results(batches: list, worker, nworkers: int, initargs,
                  label: str = "extract"):
    """Yield ``(batch index, worker(batch, index))`` for every batch, in
    completion order, from a spawned process pool that survives worker
    PROCESS death (a crash in native code, an OOM kill; per-read
    exceptions are counted inside the workers).

    One dead worker breaks the whole executor. Recovery: respawn the pool
    for the unfinished batches while rounds make progress; a round with
    no progress isolates the batches one per single-worker pool, so the
    culprit is found exactly and quarantined (result None, its files
    counted as failed by the caller) while the other batches complete.
    Reference behavior: worker death kills the run
    (extract_features.py:633-639)."""
    from concurrent.futures import CancelledError
    from concurrent.futures.process import BrokenProcessPool

    def _pool(workers: int):
        return ProcessPoolExecutor(max_workers=workers,
                                   mp_context=mp.get_context("spawn"),
                                   initializer=_init_worker,
                                   initargs=initargs)

    pending = dict(enumerate(batches))
    while pending:
        before = len(pending)
        pool = _pool(min(nworkers, len(pending)))
        broken = False
        try:
            futs = {pool.submit(worker, b, bi): bi
                    for bi, b in sorted(pending.items())}
            for fut in as_completed(futs):
                try:
                    res = fut.result()
                except (BrokenProcessPool, CancelledError):
                    broken = True
                    continue
                bi = futs[fut]
                del pending[bi]
                yield bi, res
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        if not broken:
            return
        if len(pending) < before:
            print(f"[{label}] a worker process died; respawning the pool "
                  f"for {len(pending)} unfinished batches", flush=True)
            continue
        print(f"[{label}] worker pool died with no progress; isolating "
              f"{len(pending)} batches serially", flush=True)
        for bi in sorted(pending):
            with _pool(1) as p1:
                try:
                    res = p1.submit(worker, pending[bi], bi).result()
                except (BrokenProcessPool, CancelledError):
                    print(f"[{label}] batch {bi} kills its worker — "
                          f"quarantined ({len(pending[bi])} files "
                          f"counted as failed)", flush=True)
                    res = None
            yield bi, res
        return


def _in_batch_order(results):
    """Re-order ``(index, result)`` pairs of batches 0..n-1 into index
    order, holding back those that finish early."""
    held: dict = {}
    nxt = 0
    for bi, res in results:
        held[bi] = res
        while nxt in held:
            yield nxt, held.pop(nxt)
            nxt += 1


class _RotatingSinkBase:
    """One output file, or a rotating directory of batch files with a new
    file every ``w_batch_num`` batches (reference
    extract_features.py:451-517)."""

    def __init__(self, write_path: str, is_dir: bool, w_batch_num: int,
                 is_gzip: bool):
        self._gz = is_gzip
        self._is_dir = is_dir
        self._w_batch_num = w_batch_num
        self._batch_count = 0
        self._file_count = 0
        if is_dir:
            if os.path.exists(write_path) and os.path.isfile(write_path):
                raise FileExistsError(
                    f"{write_path} already exists as a file, please use "
                    "another write_dir")
            os.makedirs(write_path, exist_ok=True)
            self._dir = write_path
            self._fh = self._open_next()
        else:
            self._fh = self._open(gzip_path(write_path) if is_gzip
                                  else write_path)

    def _open_next(self):
        ext = ".tsv.gz" if self._gz else ".tsv"
        return self._open("/".join([self._dir,
                                    str(self._file_count) + ext]))

    def _advance(self):
        """Rotate (dir mode) before a batch; _batch_done counts it."""
        if self._is_dir and self._batch_count >= self._w_batch_num:
            self._fh.close()
            self._file_count += 1
            self._fh = self._open_next()
            self._batch_count = 0

    def _batch_done(self):
        self._batch_count += 1

    def close(self):
        self._fh.close()


class _RotatingWriter(_RotatingSinkBase):
    """Row-level sink of single-process runs."""

    def _open(self, path: str):
        if self._gz:
            import gzip as _gzip
            return _gzip.open(path, "wt")
        return open(path, "w")

    def write_rows(self, rows: list[str]):
        self._advance()
        for r in rows:
            self._fh.write(r + "\n")
        self._batch_done()


class _PartConcatWriter(_RotatingSinkBase):
    """Byte-level sink of pooled runs: appends the workers' finished part
    files (plain text or gzip members) to the output. A gzip output
    becomes a multi-member stream that decompresses to the bytes of the
    single-process output."""

    def _open(self, path: str):
        return open(path, "wb")

    def append_part(self, part: str):
        self._advance()
        with open(part, "rb") as pfh:
            shutil.copyfileobj(pfh, self._fh, 4 << 20)
        os.remove(part)
        self._batch_done()


def _fast5_batches(fast5_dir: str, recursive: bool, f5_batch_size: int):
    """This rank's share of the fast5 list (all of it in one process;
    parallel/dist.shard_for_host), cut into batches."""
    fast5s = shard_for_host(get_fast5s(fast5_dir, recursive))
    print("{} fast5 files in total (this rank)..".format(len(fast5s)))
    return fast5s, [fast5s[i:i + f5_batch_size]
                    for i in range(0, len(fast5s), f5_batch_size)]


def extract_features(fast5_dir: str, is_recursive: bool,
                     ctx: ExtractContext, write_path: str, nproc: int = 4,
                     f5_batch_size: int = 30, w_is_dir: bool = False,
                     w_batch_num: int = 200, is_gzip: bool = False,
                     seed: int | None = None,
                     out_format: str = "tsv") -> tuple[int, int]:
    """Directory of fast5s -> features TSV (reference format), or a
    directory of .npz feature batches (``out_format`` npz, npz_wire or
    npz_packed: one ``<batch index>.npz`` per fast5 batch). Returns
    (n_fast5s, n_errors). Under a multi-process launch each rank takes
    its share of the fast5s and writes ``host_output_path(write_path)``
    (a ``.host<RANK>`` file or directory)."""
    if out_format != "tsv" and out_format not in NPZ_SAVERS:
        raise ValueError(f"unknown --w_format {out_format}")
    write_path = host_output_path(write_path)
    print("[main] extract_features starts..")
    t0 = time.time()
    if not os.path.isdir(fast5_dir):
        raise ValueError("--fast5_dir is not a directory!")
    as_npz = out_format in NPZ_SAVERS
    if as_npz:
        if os.path.isfile(write_path):
            raise FileExistsError(f"{write_path} exists as a file")
        if out_format == "npz_packed":
            # the packed wire is float16: the rect is assembled natively
            # at that dtype (the same rounding)
            ctx = dc_replace(ctx, opts=dc_replace(ctx.opts, rect_f16=True))
        os.makedirs(write_path, exist_ok=True)
    fast5s, batches = _fast5_batches(fast5_dir, is_recursive, f5_batch_size)
    errors = 0
    nworkers = max(1, min(nproc, len(batches)))
    if as_npz and nworkers == 1:
        _init_worker(ctx, seed, (write_path, out_format))
        for bi, b in enumerate(batches):
            errors += _worker_batch_save(b, bi)[1]
    elif as_npz:
        results = _pool_results(batches, _worker_batch_save, nworkers,
                                (ctx, seed, (write_path, out_format)))
        try:
            for bi, res in results:
                errors += len(batches[bi]) if res is None else res[1]
        finally:
            results.close()
        # a save killed before its rename leaves only its dot-temp
        for f in os.listdir(write_path):
            if f.startswith(".") and f.endswith(".npz.tmp"):
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(write_path, f))
    elif nworkers == 1:
        writer = _RotatingWriter(write_path, w_is_dir, w_batch_num, is_gzip)
        try:
            _init_worker(ctx, seed)
            for bi, b in enumerate(batches):
                rows, err = _worker_rows(b, bi)
                writer.write_rows(rows)
                errors += err
        finally:
            writer.close()
    else:
        writer = _PartConcatWriter(write_path, w_is_dir, w_batch_num,
                                   is_gzip)
        # created after the writer: a writer that fails to open must not
        # leave a hidden parts directory next to the user's output
        parent = os.path.dirname(os.path.abspath(write_path)) or "."
        part_dir = tempfile.mkdtemp(prefix=".extract_parts_", dir=parent)
        results = _pool_results(batches, _worker_rows_part, nworkers,
                                (ctx, seed, (part_dir, is_gzip)))
        try:
            for bi, res in _in_batch_order(results):
                if res is None:       # quarantined: its part is partial
                    errors += len(batches[bi])
                    continue
                errors += res[1]
                writer.append_part(part_path(part_dir, bi))
        finally:
            results.close()
            writer.close()
            shutil.rmtree(part_dir, ignore_errors=True)
    print("%d of %d fast5 files failed..\n"
          "[main] extract_features costs %.1f seconds.." % (
              errors, len(fast5s), time.time() - t0))
    return len(fast5s), errors


def extract_options_from_args(args, methy_label: int = 1) -> ExtractOptions:
    return ExtractOptions(
        corrected_group=args.corrected_group,
        basecall_subgroup=args.basecall_subgroup,
        normalize_method=args.normalize_method, motifs=args.motifs,
        mod_loc=args.mod_loc, kmer_len=args.seq_len,
        signal_len=args.signal_len, methy_label=methy_label,
        positions=args.positions, region=args.region,
        reference_path=args.reference_path, downsample=args.downsample)


def extract_to_call_mods(engine, fast5_dir: str, args,
                         result_file: str | None = None,
                         is_gzip: bool | None = None):
    """The fused fast5 -> call_mods path (reference GPU pipeline,
    call_modifications.py:361-442): extraction workers produce the
    engine's input blocks, the engine runs them on its device.

    float16 wire: read-packed blocks (features_to_packed; windows
    gathered on the card, as on the TSV plane). float32 wire:
    features_to_batch on the per-site route. Pooled workers hand them
    over as v3 or v1 .npz containers (_worker_batch_save). Blocks reach
    the engine in fast5-batch order, so the output does not depend on
    ``nproc``."""
    from ..io.batching import PrefetchIterator

    result_file = result_file or args.result_file
    is_gzip = getattr(args, "gzip", False) if is_gzip is None else is_gzip
    f16 = engine.call_cfg.transfer_dtype != "float32"
    opts = extract_options_from_args(args)
    if f16:
        opts = dc_replace(opts, rect_f16=True)
    ctx = ExtractContext.build(opts, str2bool(args.is_dna))
    fast5s, batches = _fast5_batches(fast5_dir, str2bool(args.recursively),
                                     args.f5_batch_size)
    # extraction workers are CPU-bound: more than the host's cores only
    # thrash
    nworkers = max(1, min(args.nproc, len(batches), os.cpu_count() or 4))
    errors = [0]
    part_dir = None

    def in_process():
        _init_worker(ctx, None)
        for bi, b in enumerate(batches):
            blk, err = _worker_block(b, bi)
            errors[0] += err
            if blk is not None:
                yield blk

    def pooled():
        load = load_packed_npz if f16 else load_feature_npz
        results = _pool_results(batches, _worker_batch_save, nworkers,
                                (ctx, None, (part_dir, "npz_packed" if f16
                                             else "npz")),
                                label="fused extract")
        try:
            for bi, res in _in_batch_order(results):
                if res is None:
                    errors[0] += len(batches[bi])
                    continue
                n, err = res
                errors[0] += err
                if n:
                    path = npz_batch_path(part_dir, bi)
                    blk = load(path)
                    os.remove(path)
                    yield blk
        finally:
            results.close()

    if nworkers > 1:
        parent = os.path.dirname(os.path.abspath(result_file)) or "."
        part_dir = tempfile.mkdtemp(prefix=".fused_parts_", dir=parent)
    blocks = PrefetchIterator(pooled() if nworkers > 1 else in_process(),
                              depth=4)
    try:
        stats = engine.run_blocks(blocks, result_file, is_gzip,
                                  packed=f16)
    finally:
        blocks.close()
        if part_dir is not None:
            shutil.rmtree(part_dir, ignore_errors=True)
    stats.fast5_files = len(fast5s)
    stats.fast5_errors = errors[0]
    print("%d of %d fast5 files failed.." % (errors[0], len(fast5s)))
    return stats
