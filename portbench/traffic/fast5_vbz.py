"""Traffic kind ``fast5_vbz``: the reads' sites as a directory of
single-read tombo fast5s, one a read, their signals VBZ-compressed as
MinKNOW writes them, and the genome's FASTA beside the directory (what
``call_mods --input_path <dir> --reference_path <fasta>`` reads).

The reads are lib/reads.py's (one ``read_chunks`` chunk a read; the last
read cut after its last site, so that extraction finds the input's sites
exactly). Per base, lib/reads.py's mean and std are a level and a noise,
its length the samples it spans: each sample is level + noise * N(0, 1),
then ``pa_shift + pa_scale * x`` picoamps, stored as the DAC integers of
the traffic's channel. Before the first event and after the last, the
read holds ``lead_bases`` and ``tail_bases`` more such bases that the
event table leaves out (``read_start_rel_to_raw`` counts the lead).

Each file is written by the benchmark's frozen HDF5 writer and VBZ
encoder (lib/hdf5w.py, lib/vbz.py); this module imports nothing of the
program. The sampled sites' expected rows and model inputs come from the
plain extraction reference (reference/extract.py), given the values
written. Rows come in the order the program lists the directory
(``os.walk``, unsorted), which this module reads back once the files are
written, as the program does.
"""
from __future__ import annotations

import contextlib
import fnmatch
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench.lib import hdf5w, vbz
from portbench.lib import sample as smp
from portbench.lib.reads import BASES, CODE, genome, read_chunks
from portbench.reference import extract as ref

#: the fast5s' directory, beside the work directory's other files
FAST5_DIR = "fast5"
#: threads that draw, encode and write the reads (numpy and zstd release
#: the interpreter lock); the bytes do not depend on their number
THREADS = 4


def _fasta(path: str, p: dict, seed: int) -> dict[str, int]:
    """The genome that lib/reads.py draws first from ``seed``, as FASTA;
    each contig's length."""
    contigs = genome(np.random.default_rng(seed), p["contigs"],
                     float(p["gc"]))
    with open(path, "wb") as fh:
        for name, codes in contigs.items():
            seq = BASES[codes].tobytes()
            fh.write(b">" + name.encode() + b"\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i:i + 80] + b"\n")
    return {name: len(c) for name, c in contigs.items()}


def _read(chunk, i: int, p: dict, seed: int) -> ref.Fast5Read:
    """One read's fast5 content from its chunk (one read a chunk)."""
    a, ch = p["assumed"], p["channel"]
    nb = int(p["kmer_len"]) // 2
    codes = chunk.codes
    full = int(np.count_nonzero(codes[nb:len(codes) - nb] == CODE[
        p["motif"]]))
    if chunk.n < full:                   # the last read, cut at its sites
        codes = codes[:int(chunk.center[-1]) + nb + 1]
    L = len(codes)
    c0, pos0 = int(chunk.center[0]), int(chunk.pos[0])
    minus = chunk.strand[0] == b"-"
    rng = np.random.default_rng([seed, 0xF5, i])
    lead = int(rng.integers(*a["lead_bases"]))
    tail = int(rng.integers(*a["tail_bases"]))
    level = np.concatenate([rng.standard_normal(lead),
                            chunk.means[:L] / 1e6,
                            rng.standard_normal(tail)])
    noise = np.concatenate([np.abs(rng.normal(0.2, 0.08, lead)),
                            chunk.stds[:L] / 1e6,
                            np.abs(rng.normal(0.2, 0.08, tail))])
    lens = np.concatenate([rng.integers(3, 30, lead), chunk.lens[:L],
                           rng.integers(3, 30, tail)])
    x = np.repeat(level, lens) + np.repeat(noise, lens) * \
        rng.standard_normal(int(lens.sum()))
    pa = a["pa_shift"] + a["pa_scale"] * x
    scaling = ch["range"] / ch["digitisation"]
    dac = np.round(pa / scaling - ch["offset"]).astype(np.int16)
    starts = np.cumsum(lens[lead:lead + L]) - lens[lead:lead + L]
    return ref.Fast5Read(
        readname=chunk.read_name[0].decode(), chrom=chunk.chrom[0].decode(),
        mapped_start=(pos0 + c0 - L + 1) if minus else (pos0 - c0),
        strand="-" if minus else "+", dac=dac,
        digitisation=float(ch["digitisation"]), prange=float(ch["range"]),
        offset=float(ch["offset"]), rel=int(lens[:lead].sum()),
        bases=BASES[codes].tobytes(), starts=starts,
        lengths=lens[lead:lead + L])


def write(path: str, read: ref.Fast5Read, p: dict) -> None:
    """``read`` as a VBZ tombo fast5 (``FAULTS`` wrap lib/hdf5w.py's
    writer)."""
    ch = p["channel"]
    hdf5w.write_tombo_fast5(
        path, read.readname, read.dac, read.bases, read.starts,
        read.lengths, read.chrom, read.mapped_start, read.strand,
        read.digitisation, read.prange, read.offset, read.rel,
        int(ch["chunk_samples"]), ((vbz.FILTER_ID, tuple(ch["vbz"])),),
        vbz.chunk_encoder(tuple(ch["vbz"])))


def listed(fast5_dir: str) -> list[str]:
    """The fast5s' names in the order ``os.walk`` gives them."""
    return fnmatch.filter(next(os.walk(fast5_dir))[2], "*.fast5")


def _made(chunk, i: int, p: dict, seed: int, path: str):
    """One read drawn and written: (its content, its bytes, its
    normalisation)."""
    read = _read(chunk, i, p, seed)
    write(path, read, p)
    return read, os.path.getsize(path), ref.shift_scale(read)


def make(p: dict, seed: int, workdir: str, check_sites: int) -> smp.Input:
    L, S = int(p["kmer_len"]), int(p["signal_len"])
    path = os.path.join(workdir, FAST5_DIR)
    os.makedirs(path)
    fasta = os.path.join(workdir, p["fasta"])
    chrom_len = _fasta(fasta, p, seed)
    jobs = {}
    with ThreadPoolExecutor(THREADS) as pool:
        for i, chunk in enumerate(read_chunks(p, seed, 1)):
            if not chunk.n:
                continue
            name = f"read{i:05d}.fast5"
            # made here in read order, filled by the threads: the
            # directory lists the same order in every run on a filesystem
            open(os.path.join(path, name), "wb").close()
            jobs[name] = pool.submit(_made, chunk, i, p, seed,
                                     os.path.join(path, name))
        made = {name: job.result() for name, job in jobs.items()}
    nbytes = os.path.getsize(fasta) + sum(m[1] for m in made.values())
    order = listed(path)
    centres = [ref.sites(made[f][0], p["motif"], 0, L) for f in order]
    first = np.cumsum([0] + [len(c) for c in centres])
    sites = int(first[-1])
    if sites != int(p["sites"]):
        raise RuntimeError(f"{sites} sites written, {p['sites']} asked")
    index = smp.draw(seed, sites, check_sites)
    parts = []
    for k, f in enumerate(order):
        lo, hi = np.searchsorted(index, first[k:k + 2])
        if hi > lo:
            read, _, norm = made[f]
            parts.append(ref.site_features(
                read, chrom_len[read.chrom],
                centres[k][index[lo:hi] - first[k]], L, S, norm))
    sample = smp.Sample(
        index, [s for q in parts for s in q["info"]],
        [s for q in parts for s in q["kmer5"]],
        *(np.concatenate([q[k] for q in parts])
          for k in ("kmer", "means", "stds", "lens", "signals")))
    return smp.Input(path, sites, nbytes, sample)


# What the comparison has to catch in this kind's input, for calibrate.py
# and the tests (run.py never plants one): context managers over the
# frozen writer, under which every fast5 goes through
# ``fn(write, path, *args)``; the reference still gets the values drawn.

#: the file that a fault breaks: the first read's
FAULTY = "read00000.fast5"


@contextlib.contextmanager
def _writes(fn):
    saved = hdf5w.write_tombo_fast5
    hdf5w.write_tombo_fast5 = lambda path, *a, **k: fn(saved, path, *a, **k)
    try:
        yield
    finally:
        hdf5w.write_tombo_fast5 = saved


def emptied():
    """The first read's fast5 written empty, so the program cannot read
    it."""
    def fn(write, path, *a, **k):
        if os.path.basename(path) != FAULTY:
            return write(path, *a, **k)
        open(path, "wb").close()
    return _writes(fn)


def signal_altered():
    """The first read's raw signal written mirrored about its median
    (its events, bases and alignment as drawn)."""
    def fn(write, path, readname, raw, *a, **k):
        if os.path.basename(path) == FAULTY:
            raw = (2 * int(np.median(raw)) - raw.astype(np.int64)).astype(
                np.int16)
        return write(path, readname, raw, *a, **k)
    return _writes(fn)


FAULTS = {"fast5_emptied": emptied, "signal_altered": signal_altered}
