"""call_freq — genome-level methylation frequency aggregation (counterpart
of deepsignal_plant_tpu/pipeline/call_freq.py:38-597).

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
spawn process pool over contigs on the host.

Pod mode (a multi-process launch, WORLD_SIZE > 1): each rank aggregates
its share of the inputs (``--pod_shard_inputs``, _pod_resolve_inputs)
and rank 0 merges the ranks' site tables in rank order and writes the
one output (merge_across_hosts); with ``--contigs`` the ranks share out
the contigs instead and each writes ``<root>.host<RANK><ext>``.
"""
from __future__ import annotations

import hashlib
import io
import os
import time
import uuid

import numpy as np

from ..io.batching import iter_byte_blocks
from ..parallel.dist import host_output_path, process_info, shard_for_host
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

    def merge_table(self, chroms: list[str], gid, pos, strand, pis, prob0,
                    prob1, met, coverage, kmers: list[str]) -> None:
        """Merge a per-site table (one row a site, keys unique within the
        table): the cross-rank reduction step."""
        if len(pos) == 0:
            return
        gids = self._intern_chroms(list(chroms))[np.asarray(gid)]
        keys = gids * _KEY_SHIFT + np.asarray(pos)
        g_of = self._resolve_and_append(
            keys, np.arange(len(keys)), gids, np.asarray(pos),
            np.asarray(strand), np.asarray(pis), lambda j: str(kmers[j]))
        np.add.at(self._prob0, g_of, prob0)
        np.add.at(self._prob1, g_of, prob1)
        np.add.at(self._met, g_of, met)
        np.add.at(self._coverage, g_of, coverage)

    def payload_bytes(self) -> bytes:
        """The aggregation state as npz bytes of fixed-dtype arrays (the
        JAX package's ``state_payload``, without pickle)."""
        n = self.n_sites
        fh = io.BytesIO()
        np.savez(fh, chroms=np.array(self._chroms, dtype=str),
                 gid=self._gid[:n], pos=self._pos[:n],
                 strand=self._strand[:n], pis=self._pis[:n],
                 prob0=self._prob0[:n], prob1=self._prob1[:n],
                 met=self._met[:n], coverage=self._coverage[:n],
                 kmers=np.array(self._kmers, dtype=str))
        return fh.getvalue()

    def merge_payload(self, raw: bytes) -> None:
        """Merge another accumulator's ``payload_bytes``."""
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            self.merge_table(**{k: z[k] for k in z.files})

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


def merge_across_hosts(acc: FreqAccumulator) -> FreqAccumulator:
    """Reduce the ranks' accumulators over collectives (JAX
    call_freq.py:242-276): every rank's site table goes out in one
    chunked all-gather (parallel/multihost.allgather_bytes) and rank 0,
    the one writer, merges them in rank order, so first-seen metadata and
    the unsorted row order do not depend on timing. The other ranks never
    hold the others' tables; they return an accumulator that carries
    only the exact global count and used, so ``report()`` agrees on every
    rank."""
    rank, world = process_info()
    if world == 1:
        return acc
    from ..parallel.multihost import allgather_bytes, global_sum
    payloads = allgather_bytes(acc.payload_bytes(), keep=rank == 0)
    merged = FreqAccumulator(prob_cf=acc.prob_cf, contig=acc.contig)
    for raw in payloads:
        merged.merge_payload(raw)
    # float64 sums of integer counts are exact below 2**53 calls
    count, used = global_sum([acc.count, acc.used])
    merged.count, merged.used = int(count), int(used)
    return merged


def _pod_input_fingerprint(f: str) -> str:
    """A file's identity for the shared-list check (JAX
    call_freq.py:422-455): its absolute path, size and a content hash
    (whole up to 512 KiB; else head, six interior chunks and tail), so
    that same-path files of equal size but other content (per-rank local
    shards written to one path) do not pass as one shared file."""
    size = os.path.getsize(f)
    h = hashlib.sha256()
    chunk = 65536
    with open(f, "rb") as fh:
        if size <= 8 * chunk:
            for blk in iter(lambda: fh.read(chunk), b""):
                h.update(blk)
        else:
            h.update(fh.read(chunk))
            for i in range(1, 7):
                fh.seek(chunk + (size - 2 * chunk) * i // 7)
                h.update(fh.read(chunk))
            fh.seek(-chunk, os.SEEK_END)
            h.update(fh.read(chunk))
    return "{}\t{}\t{}".format(os.path.abspath(f), size,
                               h.hexdigest()[:16])


def _pod_resolve_inputs(mods_files: list[str], mode: str) -> tuple[
        list[str], bool]:
    """This rank's input list in pod mode -> (files, shared_fs) (JAX
    call_freq.py:458-505). On a shared filesystem every rank sees every
    file, so the list is sharded (or every count would be multiplied by
    the world size); on per-rank disjoint inputs each rank keeps its
    own. ``mode``: ``always`` shards, ``never`` keeps, ``auto`` gathers
    every rank's fingerprints and shards when all lists match, keeps
    them when their paths are pairwise disjoint, and raises on a partial
    overlap."""
    if mode == "always":
        return shard_for_host(mods_files), True
    if mode == "never":
        return list(mods_files), False
    from ..parallel.multihost import allgather_bytes
    ident = "\n".join(_pod_input_fingerprint(f) for f in sorted(mods_files))
    payloads = allgather_bytes(ident.encode())
    sets = [set(p.decode().splitlines()) if p else set() for p in payloads]
    if all(s == sets[0] for s in sets):
        out = shard_for_host(mods_files)
        print("pod mode: shared input list; this rank aggregates {} of {} "
              "file(s)".format(len(out), len(mods_files)))
        return out, True
    # disjointness is judged on paths alone: one path seen with two
    # fingerprints (a file mid-write, per-rank local files at one path)
    # is not two disjoint files
    path_sets = [set(line.split("\t", 1)[0] for line in s) for s in sets]
    if sum(len(s) for s in path_sets) == len(set().union(*path_sets)):
        print("pod mode: disjoint per-rank inputs; this rank aggregates "
              "all {} local file(s)".format(len(mods_files)))
        return list(mods_files), False
    raise ValueError(
        "pod call_freq: the ranks' input lists neither match exactly "
        "(same paths, sizes and content samples) nor are pairwise "
        "disjoint: a partially overlapping partition, a shared file seen "
        "mid-write, or per-rank local files at one path. Refusing to "
        "guess the partition (counts would be dropped or double-counted). "
        "Pass --pod_shard_inputs always (shared filesystem) or never "
        "(disjoint per-rank inputs) to assert the layout.")


def call_mods_frequency_to_file(args) -> None:
    """CLI entry, mirroring call_mods_freq.py:218; pod mode under a
    multi-process launch (JAX call_freq.py:508-597)."""
    print("[main]call_freq starts..")
    t0 = time.time()
    mods_files = collect_mods_files(args.input_path, args.file_uid)
    print("get {} input file(s)..".format(len(mods_files)))
    contigs = resolve_contigs(args.contigs)
    device_agg = args.device_agg
    device = args.device
    pod = process_info()[1] > 1

    if contigs is None:
        if pod:
            mods_files, _ = _pod_resolve_inputs(mods_files,
                                                args.pod_shard_inputs)
        acc = FreqAccumulator(prob_cf=args.prob_cf, device_agg=device_agg,
                              device=device)
        for f in mods_files:
            acc.add_file(f)
        if pod:
            acc = merge_across_hosts(acc)
        print(acc.report())
        if process_info()[0] == 0:
            write_freq(acc, args.result_file, args.sort, args.bed,
                       args.gzip)
    else:
        result_file = args.result_file
        if pod:
            # a shared list shares out the contigs over ranks, each over
            # every file; disjoint per-rank inputs keep every contig (a
            # contig's rows may sit in any rank's files). Either way each
            # rank writes its own suffixed output (merge downstream with
            # `tools combine_freq_files`).
            mods_files, shared_fs = _pod_resolve_inputs(
                mods_files, args.pod_shard_inputs)
            if shared_fs:
                mods_files = collect_mods_files(args.input_path,
                                                args.file_uid)
                contigs = shard_for_host(contigs)
            result_file = host_output_path(result_file)
            print("pod mode: this rank takes {} contig(s) over {} file(s) "
                  "-> {}".format(len(contigs), len(mods_files),
                                 result_file))
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
