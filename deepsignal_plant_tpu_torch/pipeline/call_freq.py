"""call_freq — genome-level methylation frequency aggregation (counterpart
of deepsignal_plant_tpu/pipeline/call_freq.py:38-240, :317-420 and
:508-597).

Reference behavior (call_mods_freq.py:29-296): stream call_mods rows, drop
ambiguous calls (|p0-p1| < prob_cf), accumulate per-site probability sums /
met / unmet / coverage, emit an 11-column TSV or bedMethyl, optionally
sorted, optionally contig-parallel.

Byte blocks are parsed by the native row parser (featparse.cpp
dsp_parse_calls; no Python fallback), ambiguity-filtered as a vector,
block-deduped with np.unique, and segment-summed with np.add.at into flat
per-site arrays; the Python dict holds only site key -> array index.
np.add.at iterates in row order, so per-site float sums associate exactly
like the reference's sequential accumulation (call_mods_freq.py:60-66).
The first-seen strand/pos_in_strand/kmer per site (call_mods_freq.py:55-59)
comes from np.unique's first-occurrence indices.

``--device_agg`` moves each block's site sort and integer segment sums to
the device (ops/segment_agg.py; the card unless ``--device cpu``); the
float64 probability sums stay on the host in file order within a site,
so the output is byte-identical. Without it call_freq is host-only and
needs no card. Contig-parallel mode (``-p > 1``, several contigs) runs a
spawn process pool over contigs on the host. Pod mode (the JAX package's
multi-host merge) is not yet ported.
"""
from __future__ import annotations

import os
import time
import uuid

import numpy as np

from ..io.batching import iter_byte_blocks
from ..utils.fasta import get_contig_names, is_genome_fasta
from ..utils.fastparse import parse_call_bytes
from ..utils.formats import (format_bed_row, format_freq_row, gzip_path,
                             open_text)

# site key = chrom_id * 2^40 + pos: positions fit well under 2^40 for any
# genome; 2^23 contigs headroom in a signed int64
_KEY_SHIFT = np.int64(1) << 40


class FreqAccumulator:
    """Streaming per-site accumulator over call_mods rows. With
    ``device_agg`` each block's site sort and integer sums run on
    ``device`` (resolved here: the card unless it is "cpu")."""

    def __init__(self, prob_cf: float = 0.5, contig: str | None = None,
                 device_agg: bool = False, device=None):
        self.prob_cf = prob_cf
        self.contig = contig
        self.device_agg = device_agg
        self.device = None
        if device_agg:
            from ..utils.device import resolve_device
            self.device = resolve_device(device)
        self.count = 0
        self.used = 0
        self._chrom2gid: dict[str, int] = {}
        self._chroms: list[str] = []
        self._key2idx: dict[int, int] = {}
        self.n_sites = 0
        cap = 1024
        self._gid = np.empty(cap, np.int64)
        self._pos = np.empty(cap, np.int64)
        self._strand = np.empty(cap, np.uint8)
        self._pis = np.empty(cap, np.int64)
        self._prob0 = np.zeros(cap, np.float64)
        self._prob1 = np.zeros(cap, np.float64)
        self._met = np.zeros(cap, np.int64)
        self._coverage = np.zeros(cap, np.int64)
        self._kmers: list[str] = []

    def _grow(self, extra: int) -> None:
        need = self.n_sites + extra
        cap = len(self._pos)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("_gid", "_pos", "_strand", "_pis", "_prob0", "_prob1",
                     "_met", "_coverage"):
            old = getattr(self, name)
            new = (np.zeros if old.dtype != np.uint8 else np.empty)(
                cap, old.dtype)
            new[:self.n_sites] = old[:self.n_sites]
            setattr(self, name, new)

    def add_file(self, path: str, block_bytes: int = 8 << 20) -> None:
        for raw in iter_byte_blocks(path, block_bytes):
            self._add_block(parse_call_bytes(raw))

    def _intern_chroms(self, names: list[str]) -> np.ndarray:
        """Map block-local chrom names to global ids (interning new
        ones), returned as a local-id -> global-id lookup table."""
        lg2g = np.empty(len(names), np.int64)
        for j, name in enumerate(names):
            g = self._chrom2gid.get(name)
            if g is None:
                g = len(self._chroms)
                self._chrom2gid[name] = g
                self._chroms.append(name)
            lg2g[j] = g
        return lg2g

    def _resolve_and_append(self, ukeys, order_vals, gid_u, pos_u,
                            strand_u, pis_u, kmer_of) -> np.ndarray:
        """Map unique site keys to global table rows, appending unseen
        sites in ascending ``order_vals`` order (the first-occurrence /
        insertion-order contract, reference call_mods_freq.py:55-59).
        Metadata arrays are per-unique-key; ``kmer_of(j)`` returns key
        j's kmer string. Shared by the host and the device block paths."""
        g_of = np.empty(len(ukeys), np.int64)
        k2i = self._key2idx
        new_local: list[int] = []
        for j, k in enumerate(ukeys.tolist()):
            gi = k2i.get(k)
            if gi is None:
                new_local.append(j)
                gi = -1
            g_of[j] = gi
        if new_local:
            new_local.sort(key=lambda j: order_vals[j])
            base = self.n_sites
            self._grow(len(new_local))
            nl = np.asarray(new_local)
            g_of[nl] = base + np.arange(len(new_local))
            for t, j in enumerate(new_local):
                k2i[int(ukeys[j])] = base + t
            sl = slice(base, base + len(new_local))
            self._gid[sl] = gid_u[nl]
            self._pos[sl] = pos_u[nl]
            self._strand[sl] = strand_u[nl]
            self._pis[sl] = pis_u[nl]
            self._kmers.extend(kmer_of(int(j)) for j in new_local)
            self.n_sites += len(new_local)
        return g_of

    def _add_block(self, cb) -> None:
        n = len(cb)
        if n == 0:
            return
        gids = self._intern_chroms(cb.chroms)[cb.chrom_ids]

        keep = np.abs(cb.p0 - cb.p1) >= self.prob_cf
        if self.contig is not None:
            # off-contig rows are skipped before counting
            # (call_mods_freq.py:52-53 continues before count += 1)
            try:
                target = cb.chroms.index(self.contig)
            except ValueError:
                return
            on_contig = cb.chrom_ids == target
            self.count += int(on_contig.sum())
            keep &= on_contig
        else:
            self.count += n
        self.used += int(keep.sum())
        rows = np.nonzero(keep)[0]
        if len(rows) == 0:
            return
        # the JAX package's int32 device keys cannot carry positions past
        # 2**31-1 (giant-chromosome assemblies); such blocks take the host
        # path here too, so both packages branch alike
        if self.device_agg and int(cb.pos[rows].max()) < 2**31:
            self._add_rows_device(cb, gids, rows)
            return

        keys = gids[rows] * _KEY_SHIFT + cb.pos[rows]
        ukeys, first_idx, inverse = np.unique(
            keys, return_index=True, return_inverse=True)
        src_rows = rows[first_idx]
        g_of_u = self._resolve_and_append(
            ukeys, first_idx, gids[src_rows], cb.pos[src_rows],
            cb.strand[src_rows], cb.pos_in_strand[src_rows],
            lambda j: cb.kmer_at(int(src_rows[j])))
        ridx = g_of_u[inverse]
        np.add.at(self._prob0, ridx, cb.p0[rows])
        np.add.at(self._prob1, ridx, cb.p1[rows])
        np.add.at(self._met, ridx, cb.label[rows])
        np.add.at(self._coverage, ridx, 1)

    def _add_rows_device(self, cb, gids, rows) -> None:
        """Device block aggregation: the kept rows sorted by (chrom, pos)
        on the device, with exact integer segment sums; the host resolves
        block-unique sites against the global table and drives float64
        ``np.add.at`` with the sorted order. The stable sort keeps file
        order within each site, so the float sums associate exactly like
        ``_add_block``'s."""
        from ..ops.segment_agg import sort_segment_reduce
        order, seg, cov_seg, met_seg, _ = sort_segment_reduce(
            gids[rows], cb.pos[rows], cb.label[rows], self.device)
        srows = rows[order]          # site-sorted, file order within site
        first_rows = srows[np.flatnonzero(np.diff(seg, prepend=-1))]
        ukeys = gids[first_rows] * _KEY_SHIFT + cb.pos[first_rows]
        g_of_u = self._resolve_and_append(
            ukeys, first_rows, gids[first_rows], cb.pos[first_rows],
            cb.strand[first_rows], cb.pos_in_strand[first_rows],
            lambda j: cb.kmer_at(int(first_rows[j])))
        np.add.at(self._prob0, g_of_u[seg], cb.p0[srows])
        np.add.at(self._prob1, g_of_u[seg], cb.p1[srows])
        self._met[g_of_u] += met_seg
        self._coverage[g_of_u] += cov_seg

    def report(self) -> str:
        pct = self.used / float(self.count) * 100 if self.count else 0.0
        tag = "" if self.contig is None else f" for {self.contig}"
        return "{:.2f}% ({} of {}) calls used{}..".format(
            pct, self.used, self.count, tag)


def write_freq(acc: FreqAccumulator, result_file: str, is_sort: bool,
               is_bed: bool, is_gzip: bool) -> None:
    """Emit the accumulated sites (call_mods_freq.py:77-122 formats)."""
    n = acc.n_sites
    gid = acc._gid[:n]
    pos = acc._pos[:n]
    chrom_names = np.array(acc._chroms, dtype=str)[gid] if n else \
        np.empty(0, dtype="U1")
    if is_sort:
        # reference sorts (chrom_str, pos) tuples: string-major
        order = np.lexsort((pos, chrom_names))
    else:
        order = np.arange(n)
    coverage = acc._coverage[:n]
    met = acc._met[:n]
    unmet = coverage - met
    prob0 = acc._prob0[:n]
    prob1 = acc._prob1[:n]
    strand = acc._strand[:n]
    pis = acc._pis[:n]
    kmers = acc._kmers
    path = gzip_path(result_file) if is_gzip else result_file
    wf = open_text(path, "wt") if is_gzip else open(path, "w")
    try:
        for i in order.tolist():
            cov = int(coverage[i])
            if cov <= 0:
                print(f"{chrom_names[i]} {pos[i]} has no coverage..")
                continue
            rmet = float(met[i]) / cov
            if is_bed:
                wf.write(format_bed_row(str(chrom_names[i]), int(pos[i]),
                                        chr(strand[i]), cov, rmet) + "\n")
            else:
                wf.write(format_freq_row(
                    str(chrom_names[i]), int(pos[i]), chr(strand[i]),
                    int(pis[i]), float(prob0[i]), float(prob1[i]),
                    int(met[i]), int(unmet[i]), cov, rmet,
                    kmers[i]) + "\n")
    finally:
        wf.close()


def _freq_one_contig(contig: str, mods_files: list[str], prob_cf: float,
                     result_file: str, issort: bool, isbed: bool,
                     device_agg: bool = False, device=None) -> str:
    """Worker: aggregate one contig into its own temp result file
    (reference _call_and_write_modsfreq_process, call_mods_freq.py:175)."""
    acc = FreqAccumulator(prob_cf=prob_cf, contig=contig,
                          device_agg=device_agg, device=device)
    for f in mods_files:
        acc.add_file(f)
    print(acc.report())
    fname, fext = os.path.splitext(result_file)
    c_file = fname + "." + contig + "." + str(uuid.uuid1()) + fext
    write_freq(acc, c_file, issort, isbed, False)
    return c_file


def _concat_results(contig_files: list[str], result_file: str,
                    is_gzip: bool) -> None:
    path = gzip_path(result_file) if is_gzip else result_file
    wf = open_text(path, "wt") if is_gzip else open(path, "w")
    try:
        for cfile in sorted(contig_files):
            with open(cfile) as rf:
                for line in rf:
                    wf.write(line)
            os.remove(cfile)
    finally:
        wf.close()


def resolve_contigs(contigs_arg: str | None) -> list[str] | None:
    """--contigs accepts a genome FASTA, a name-per-line file, or a
    comma-separated string (call_mods_freq.py:245-255)."""
    if contigs_arg is None:
        return None
    if os.path.isfile(contigs_arg):
        if contigs_arg.endswith((".fa", ".fasta", ".fna")) or \
                is_genome_fasta(contigs_arg):
            return get_contig_names(contigs_arg)
        with open(contigs_arg) as rf:
            return sorted(set(rf.read().splitlines()))
    return sorted(set(contigs_arg.strip().split(",")))


def collect_mods_files(input_paths: list[str],
                       file_uid: str | None) -> list[str]:
    """Expand --input_path entries (files or directories), filtering by
    --file_uid (call_mods_freq.py:230-243)."""
    mods_files = []
    for ipath in input_paths:
        input_path = os.path.abspath(ipath)
        if os.path.isdir(input_path):
            for ifile in os.listdir(input_path):
                if file_uid is None or ifile.find(file_uid) != -1:
                    mods_files.append("/".join([input_path, ifile]))
        elif os.path.isfile(input_path):
            mods_files.append(input_path)
        else:
            raise ValueError("--input_path is not a file or a directory!")
    return mods_files


def multi_process_env() -> bool:
    """True when a multi-process launch is configured: torch.distributed's
    environment (WORLD_SIZE > 1) or the JAX package's pod environment
    (JAX_COORDINATOR_ADDRESS with JAX_NUM_PROCESSES > 1)."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    jax_pod = bool(os.environ.get("JAX_COORDINATOR_ADDRESS")) and \
        int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0) > 1
    return world > 1 or jax_pod


def _refuse_unported(args) -> None:
    """Pod mode (the cross-host merge and input partitioning) is not
    ported: it fails here instead of every host writing a whole-genome
    output of its own inputs."""
    refused = [
        (getattr(args, "pod_shard_inputs", "auto") != "auto",
         "--pod_shard_inputs " + str(getattr(args, "pod_shard_inputs", ""))),
        (multi_process_env(), "pod mode (a multi-process environment)"),
    ]
    for hit, what in refused:
        if hit:
            raise ValueError(
                f"{what} is not yet ported to deepsignal_plant_tpu_torch "
                "(the JAX package deepsignal_plant_tpu serves it)")


def call_mods_frequency_to_file(args) -> None:
    """CLI entry, mirroring call_mods_freq.py:218."""
    _refuse_unported(args)
    print("[main]call_freq starts..")
    t0 = time.time()
    mods_files = collect_mods_files(args.input_path, args.file_uid)
    print("get {} input file(s)..".format(len(mods_files)))
    contigs = resolve_contigs(args.contigs)
    device_agg = args.device_agg
    device = args.device

    if contigs is None:
        acc = FreqAccumulator(prob_cf=args.prob_cf, device_agg=device_agg,
                              device=device)
        for f in mods_files:
            acc.add_file(f)
        print(acc.report())
        write_freq(acc, args.result_file, args.sort, args.bed, args.gzip)
    else:
        result_file = args.result_file
        print("start processing {} contigs..".format(len(contigs)))
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        nproc = max(1, args.nproc)
        if device_agg and nproc > 1 and len(contigs) > 1:
            # spawn-pool workers must not each bring up their own device
            # context
            print("[warn] --device_agg is disabled under contig-parallel "
                  "workers (-p > 1); aggregating on the host instead")
            device_agg = False
        resfiles: list[str] = []
        if nproc == 1 or len(contigs) == 1:
            for c in contigs:
                resfiles.append(_freq_one_contig(
                    c, mods_files, args.prob_cf, result_file,
                    args.sort, args.bed, device_agg, device))
        else:
            with ProcessPoolExecutor(max_workers=nproc,
                                     mp_context=mp.get_context("spawn")
                                     ) as pool:
                futs = [pool.submit(_freq_one_contig, c, mods_files,
                                    args.prob_cf, result_file,
                                    args.sort, args.bed)
                        for c in contigs]
                resfiles = [f.result() for f in futs]
        print("combine results of {} contigs..".format(len(resfiles)))
        _concat_results(resfiles, result_file, args.gzip)
    print("[main]call_freq costs %.1f seconds.." % (time.time() - t0))
