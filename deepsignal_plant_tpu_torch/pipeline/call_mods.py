"""call_mods on a features TSV or a fast5 directory (counterpart of the
TSV planes of deepsignal_plant_tpu/pipeline/call_mods.py: :106-144,
:159-228, :280-310, :677-705, :721-820, :851-1011, :1803-1918 and
:1921-1967; the fast5 directory goes through
pipeline/extract.py::extract_to_call_mods into ``run_blocks``).

Reference behavior (call_modifications.py:532-640): read 12-column
feature rows (or extract them from fast5s), run ModelBiLSTM, emit
10-column call rows.

float16 wire (the default), the read-packed route:

    byte blocks -> native parse + pack (worker threads, GIL released)
      -> batches of per-base arrays + window centres (main thread)
      -> pinned ring -> upload on a copy stream -> window gather on the
         card -> tiled forward through K1 (compute stream) -> readback
         into pinned memory
      -> native row emission (main thread) -> writer thread

The JAX package also sends float16 blocks of more than 12 bases a site
as per-site windows, to save wire bytes to a remote device. On the card
that route was slower on such input than the packed one (PERF.md):
its windows are gathered on the host's main thread, and the packed
route ships only 4 bytes a site more.

float32 wire (exact-parity runs), the per-site route: the native parser
at float32, batches of decoded rows, and ``format_call_block``.

The main thread formats and writes batch k while batch k+1's upload and
forward run on the card. Every kernel launch stays on the main thread
(the model's packed-weight cache and the launch counters are not
thread-safe). There is no fallback: on the card the forward runs the
layer kernel or the run fails, and a failed build of the native library
fails the run.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import Callable, Iterator

import numpy as np
import torch

from .. import native
from ..config import CallConfig, ModelConfig, model_config_from_args
from ..io.batching import (AsyncWriter, BatchAssembler, PrefetchIterator,
                           batches_from_features_file, bounded_thread_map,
                           default_parse_workers, iter_byte_blocks)
from ..models.bilstm import Batch, ModelBiLSTM
from ..models.convert import load_any_checkpoint
from ..ops import fused_lstm
from ..utils.device import resolve_device
from ..utils.fastparse import (emit_call_rows_arrays, format_call_block,
                               pack_raw_block, parse_raw_feature_block)

#: forward tile: wider batches run the forward in COMPUTE_TILE-row tiles
#: and the ragged tail as one narrow forward, so every row sees the
#: numerics of a forward no wider than this (the JAX package measured
#: bf16 call flips in 16384-wide forwards and none at 4096)
COMPUTE_TILE = 4096
#: batches on the card at once (uploaded, not yet written out)
INFLIGHT = 2

_TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32}


def forward_tiled(model: ModelBiLSTM, b: Batch) -> torch.Tensor:
    """Inference probabilities (N, num_classes) in <= COMPUTE_TILE-row
    forwards; ceil(N / COMPUTE_TILE) of them."""
    n = b.kmer.shape[0]
    probs = [model(Batch(*(a[lo:lo + COMPUTE_TILE] for a in b)))[1]
             for lo in range(0, n, COMPUTE_TILE)]
    return probs[0] if len(probs) == 1 else torch.cat(probs)


@dataclass
class CallStats:
    sites: int = 0
    batches: int = 0
    forward_tiles: int = 0
    device_batch: int = 0
    seconds: float = 0.0
    # called labels matching the features' label column — meaningful only
    # on labeled features (call_modifications.py:171-173)
    label_correct: int = 0
    # batches and sites by route: read-packed (the float16 wire; windows
    # gathered on the device) and per-site (the float32 wire)
    packed_batches: int = 0
    packed_sites: int = 0
    persite_batches: int = 0
    persite_sites: int = 0
    # per-base rows uploaded (packed: the deduplicated bases; per-site:
    # seq_len a site) and the bytes of every array uploaded
    bases_uploaded: int = 0
    wire_bytes: int = 0
    # parser threads' seconds in parse + pack, summed over the threads
    # (float16 plane)
    parse_seconds: float | None = None
    # main thread: waiting for parsed blocks, assembling batches (its
    # waits included), staging + upload + forward + readback (host time,
    # its waits for the card included), formatting + queueing rows
    parse_wait_seconds: float = 0.0
    batch_seconds: float = 0.0
    device_seconds: float = 0.0
    format_seconds: float = 0.0
    # the uploads' time on the card's copy stream (CUDA events; None on
    # the CPU)
    upload_device_seconds: float | None = None
    # fast5 inputs: files found, and files that failed to read or extract
    fast5_files: int | None = None
    fast5_errors: int | None = None

    @property
    def sites_per_s(self) -> float:
        return self.sites / self.seconds if self.seconds else 0.0

    @property
    def label_accuracy(self) -> float:
        return self.label_correct / self.sites if self.sites else 0.0


@dataclass
class _Batch:
    """One route-homogeneous device batch on the host."""
    route: str                   # "packed" | "persite"
    arrays: tuple                # host arrays in upload order
    n: int                       # sites
    bases: int                   # per-base rows uploaded
    labels: np.ndarray
    emit: Callable[[np.ndarray], bytes]    # (n, 2) probs -> output rows


def _check_packed_block(pb, seq_len: int, sig_len: int):
    """A block whose window or signal width differs from the model's
    fails loudly instead of gathering wrong windows."""
    if pb.kmer_len != seq_len:
        raise ValueError(
            "packed wire kmer_len {} != model seq_len {}".format(
                pb.kmer_len, seq_len))
    if pb.rect.shape[1] != sig_len:
        raise ValueError(
            "packed wire signal_len {} != model signal_len {}".format(
                pb.rect.shape[1], sig_len))
    return pb


def _take_packed_span(fifo, target, base_budget, seq_len):
    """Consume blocks from ``fifo`` ([PackedFeatureBlock, consumed]
    deque) into one packed batch: up to ``target`` sites whose covering
    base span fits ``base_budget``. Returns ((codes, means, stds, lens,
    rect, centers), segs, labels, ns, nbase) with centers rebased to the
    batch's base axis."""
    nb = (seq_len - 1) // 2
    segs = []
    cols = {k: [] for k in ("codes", "means", "stds", "lens",
                            "rect", "centers", "labels")}
    ns = nbase = 0
    while fifo and ns < target:
        ent = fifo[0]
        pb, lo = ent
        budget = base_budget - nbase
        if budget < seq_len:
            break
        centers = pb.centers
        b0 = int(centers[lo]) - nb
        hi = min(pb.n, lo + (target - ns))
        cnt = int(np.searchsorted(centers[lo:hi], b0 + budget - nb - 1,
                                  side="right"))
        if cnt == 0:
            break
        hi = lo + cnt
        b1 = int(centers[hi - 1]) + nb + 1
        cols["codes"].append(pb.codes[b0:b1])
        cols["means"].append(pb.means[b0:b1])
        cols["stds"].append(pb.stds[b0:b1])
        cols["lens"].append(pb.lens[b0:b1])
        cols["rect"].append(pb.rect[b0:b1])
        cols["centers"].append(centers[lo:hi].astype(np.int32)
                               + np.int32(nbase - b0))
        cols["labels"].append(pb.labels[lo:hi])
        segs.append((pb, lo, hi))
        nbase += b1 - b0
        ns += hi - lo
        if hi == pb.n:
            fifo.popleft()
        else:
            ent[1] = hi

    def cat(k):
        p = cols[k]
        return p[0] if len(p) == 1 else np.concatenate(p)
    arrays = tuple(cat(k) for k in ("codes", "means", "stds", "lens",
                                    "rect", "centers"))
    return arrays, segs, cat("labels"), ns, nbase


def _emit_segments(segs, probs: np.ndarray) -> bytes:
    """Output rows of a batch's sites: their info columns copied from the
    input bytes, their k-mers read back from the packed base axis."""
    out, off = [], 0
    for pb, lo, hi in segs:
        out.append(emit_call_rows_arrays(
            pb.raw, pb.row_starts[lo:hi], pb.info_ends[lo:hi],
            pb.codes[pb.window_index(lo, hi)], probs[off:off + hi - lo]))
        off += hi - lo
    return b"".join(out)


class _Slot:
    """One entry of the pinned ring: the batch's upload buffer, its
    probabilities' readback buffer, and the events that guard them."""
    __slots__ = ("host", "out", "up0", "copied", "done")

    def __init__(self):
        self.host = self.out = None
        self.up0 = self.copied = self.done = None


class _DeviceFeed:
    """Moves batches to the device and their probabilities back.

    On the card each batch's arrays are copied into one pinned buffer of
    a ring of INFLIGHT + 1 slots and uploaded by one non-blocking copy on
    a copy stream; the compute stream waits for that copy's event and
    cuts the upload into the arrays. The probabilities come back by a
    non-blocking copy into the slot's pinned output buffer behind an
    event. A slot is refilled only after the events of its last batch
    have fired. On the CPU nothing is pinned: arrays pass through as
    tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.upload_ms = 0.0
        self._k = 0
        if self.cuda:
            self._copy = torch.cuda.Stream(device)
            self._slots = [_Slot() for _ in range(INFLIGHT + 1)]

    def upload(self, arrays: tuple) -> tuple[list[torch.Tensor], _Slot | None]:
        if not self.cuda:
            return [torch.from_numpy(np.ascontiguousarray(a))
                    for a in arrays], None
        slot = self._slots[self._k % len(self._slots)]
        self._k += 1
        if slot.done is not None:
            slot.done.synchronize()
        offs, total = [], 0
        for a in arrays:
            offs.append(total)
            total += -(-a.nbytes // 64) * 64
        if slot.host is None or slot.host.numel() < total:
            slot.host = torch.empty(1 << (total - 1).bit_length(),
                                    dtype=torch.uint8, pin_memory=True)
        host = slot.host.numpy()
        for a, o in zip(arrays, offs):
            host[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(
                -1).view(np.uint8)
        compute = torch.cuda.current_stream(self.device)
        slot.up0, slot.copied = (torch.cuda.Event(enable_timing=True)
                                 for _ in range(2))
        slot.done = torch.cuda.Event()
        with torch.cuda.stream(self._copy):
            slot.up0.record()
            dev = slot.host[:total].to(self.device, non_blocking=True)
            slot.copied.record()
        compute.wait_event(slot.copied)
        dev.record_stream(compute)
        return [dev[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).view(
            a.shape) for a, o in zip(arrays, offs)], slot

    def readback(self, probs: torch.Tensor, slot: _Slot | None):
        """Start the probabilities' copy to the host; ``wait`` ends it."""
        if not self.cuda:
            return probs.numpy()
        n = probs.shape[0]
        if slot.out is None or slot.out.shape[0] < n:
            slot.out = torch.empty(probs.shape, dtype=probs.dtype,
                                   pin_memory=True)
        out = slot.out[:n]
        out.copy_(probs, non_blocking=True)
        slot.done.record()
        return out

    def wait(self, out, slot: _Slot | None) -> np.ndarray:
        """The probabilities on the host, once their copy has finished;
        valid until the slot is reused."""
        if not self.cuda:
            return out
        slot.done.synchronize()
        self.upload_ms += slot.up0.elapsed_time(slot.copied)
        return out.numpy()


class CallModsEngine:
    """Loads a checkpoint once onto ``device`` and calls feature files."""

    def __init__(self, model_path: str, model_cfg: ModelConfig,
                 call_cfg: CallConfig | None = None,
                 device: torch.device | str | None = None):
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        self.model_cfg = model_cfg
        self.call_cfg = call_cfg or CallConfig()
        self.model = ModelBiLSTM.from_params(
            load_any_checkpoint(model_path, self.model_cfg), self.model_cfg,
            self.device)
        native.load()    # build the parser now: a failed build fails here

    def run_features_file(self, input_path: str, result_path: str,
                          is_gzip: bool = False) -> CallStats:
        """features TSV -> call_mods TSV (reference else-branch,
        call_modifications.py:584-636)."""
        stats = CallStats(device_batch=self.call_cfg.device_batch)
        t0 = time.time()
        if self.call_cfg.transfer_dtype == "float32":
            batches = self._persite_f32_batches(input_path, stats)
        else:
            batches = self._packed_plane_batches(input_path, stats)
        self._run_fast(batches, result_path, is_gzip, stats)
        stats.seconds = time.time() - t0
        return stats

    def _parse_workers(self) -> int:
        return self.call_cfg.num_parse_workers or default_parse_workers()

    def _packed_plane_batches(self, input_path: str, stats: CallStats
                              ) -> Iterator[_Batch]:
        """The float16 plane of a features TSV (JAX _run_fast_tsv and
        _run_fast_packed): parser threads parse and pack 8 MiB byte
        blocks into the read-packed wire."""
        cfg = self.model_cfg
        L, S = cfg.seq_len, cfg.signal_len

        def parse_and_pack(raw: bytes):
            t = time.perf_counter()
            pb = pack_raw_block(parse_raw_feature_block(raw, L, S))
            return pb, time.perf_counter() - t

        pw = self._parse_workers()
        blocks = PrefetchIterator(
            bounded_thread_map(parse_and_pack,
                               iter_byte_blocks(input_path, 8 << 20),
                               workers=pw, depth=2 * pw), depth=4)
        stats.parse_seconds = 0.0

        def timed():
            for pb, dt in blocks:
                stats.parse_seconds += dt
                yield pb
        try:
            yield from self._packed_batches(timed(), stats)
        finally:
            blocks.close()

    def _packed_batches(self, blocks: Iterator, stats: CallStats
                        ) -> Iterator[_Batch]:
        """Read-packed batches from PackedFeatureBlocks: a batch closes
        when it holds ``device_batch`` sites or its base budget is
        full."""
        cfg = self.model_cfg
        L, S = cfg.seq_len, cfg.signal_len
        target = stats.device_batch
        base_budget = 1 << (target * L - 1).bit_length()
        fifo: deque = deque()       # [pb, consumed sites]
        pending = 0
        exhausted = False
        while True:
            while not exhausted and pending < target:
                t = time.perf_counter()
                pb = next(blocks, None)
                stats.parse_wait_seconds += time.perf_counter() - t
                if pb is None:
                    exhausted = True
                    break
                if pb.n:
                    fifo.append([_check_packed_block(pb, L, S), 0])
                    pending += pb.n
            if not fifo:
                return
            arrays, segs, labels, ns, nbase = _take_packed_span(
                fifo, target, base_budget, L)
            pending -= ns
            yield _Batch("packed", arrays, ns, nbase, labels,
                         partial(_emit_segments, segs))

    def _persite_f32_batches(self, input_path: str, stats: CallStats
                             ) -> Iterator[_Batch]:
        """The float32 plane of a features TSV: the native parser at
        float32 in parser threads, batches of ``device_batch`` rows."""
        cfg = self.model_cfg
        fbs = PrefetchIterator(batches_from_features_file(
            input_path, stats.device_batch, cfg.seq_len, cfg.signal_len,
            self._parse_workers(), out_dtype="float32"), depth=4)
        try:
            yield from self._persite_batches(fbs, stats)
        finally:
            fbs.close()

    def _persite_batches(self, fbs: Iterator, stats: CallStats
                         ) -> Iterator[_Batch]:
        """Per-site float32 batches from FeatureBatches of at most
        ``device_batch`` rows."""
        L = self.model_cfg.seq_len
        while True:
            t = time.perf_counter()
            fb = next(fbs, None)
            stats.parse_wait_seconds += time.perf_counter() - t
            if fb is None:
                return
            arrays = (fb.kmer.astype(np.int8), fb.base_means,
                      fb.base_stds, fb.base_signal_lens, fb.signals)

            def emit(probs, fb=fb) -> bytes:
                return format_call_block(fb.sampleinfo, probs,
                                         fb.kmer).encode()
            yield _Batch("persite", arrays, len(fb), len(fb) * L,
                         fb.labels, emit)

    def run_blocks(self, blocks: Iterator, result_path: str,
                   is_gzip: bool = False, packed: bool = True
                   ) -> CallStats:
        """Call input blocks in order: PackedFeatureBlocks (``packed``,
        the float16 plane) or float32 FeatureBatches of any size (the
        per-site route). The fused fast5 path feeds this
        (pipeline/extract.py::extract_to_call_mods)."""
        stats = CallStats(device_batch=self.call_cfg.device_batch)
        t0 = time.time()
        if packed:
            batches = self._packed_batches(iter(blocks), stats)
        else:
            batches = self._persite_batches(
                _rechunk(iter(blocks), stats.device_batch), stats)
        self._run_fast(batches, result_path, is_gzip, stats)
        stats.seconds = time.time() - t0
        return stats

    def _device_batch(self, route: str, tensors: list[torch.Tensor]
                      ) -> Batch:
        """The model's Batch from uploaded arrays: the packed route
        gathers each site's window from the base axis here, on the
        device (JAX _build_packed_step's jnp.take)."""
        if route == "packed":
            codes, means, stds, lens, rect, centers = tensors
            nb = (self.model_cfg.seq_len - 1) // 2
            win = centers.long()[:, None] + torch.arange(
                -nb, nb + 1, device=centers.device)[None, :]
            kmer, means, stds, lens, sig = (a[win] for a in (
                codes, means, stds, lens, rect))
        else:
            kmer, means, stds, lens, sig = tensors
        return Batch(kmer=kmer, base_means=means.float(),
                     base_stds=stds.float(), base_signal_lens=lens.float(),
                     signals=sig.float())

    def _run_fast(self, batches: Iterator[_Batch], result_path: str,
                  is_gzip: bool, stats: CallStats) -> None:
        """Upload, forward, readback and row emission of every batch
        (JAX _run_fast's dispatch loop), INFLIGHT batches on the card at
        once: batch k is formatted and written while batch k+1 runs."""
        feed = _DeviceFeed(self.device)
        writer = AsyncWriter(result_path, is_gzip)
        inflight: deque = deque()
        try:
            while True:
                t = time.perf_counter()
                b = next(batches, None)
                stats.batch_seconds += time.perf_counter() - t
                if b is None:
                    break
                t = time.perf_counter()
                tensors, slot = feed.upload(b.arrays)
                with torch.inference_mode():
                    probs = forward_tiled(
                        self.model, self._device_batch(b.route, tensors))
                inflight.append((b, feed.readback(probs, slot), slot))
                stats.device_seconds += time.perf_counter() - t
                stats.bases_uploaded += b.bases
                stats.wire_bytes += sum(a.nbytes for a in b.arrays)
                if len(inflight) == INFLIGHT:
                    self._finish(feed, *inflight.popleft(), writer, stats)
            while inflight:
                self._finish(feed, *inflight.popleft(), writer, stats)
        finally:
            batches.close()     # stops the parser threads after an error
            writer.close()
        if feed.cuda:
            stats.upload_device_seconds = feed.upload_ms / 1e3

    @staticmethod
    def _finish(feed: _DeviceFeed, b: _Batch, out, slot,
                writer: AsyncWriter, stats: CallStats) -> None:
        t = time.perf_counter()
        probs = feed.wait(out, slot)
        t1 = time.perf_counter()
        writer.write(b.emit(probs))
        called = probs[:, 1] > probs[:, 0]
        stats.label_correct += int((called == (b.labels == 1)).sum())
        stats.format_seconds += time.perf_counter() - t1
        stats.device_seconds += t1 - t
        stats.sites += b.n
        stats.batches += 1
        stats.forward_tiles += -(-b.n // COMPUTE_TILE)
        if b.route == "packed":
            stats.packed_batches += 1
            stats.packed_sites += b.n
        else:
            stats.persite_batches += 1
            stats.persite_sites += b.n


def _rechunk(fbs: Iterator, target: int) -> Iterator:
    """FeatureBatches of any size re-cut into ``target``-row batches (the
    last one shorter), in order."""
    asm = BatchAssembler(target)
    for fb in fbs:
        asm.add(fb)
        while (full := asm.pop_full()) is not None:
            yield full
    rest = asm.pop_rest()
    if rest is not None:
        yield rest


def _holds_npz(path: str) -> bool:
    return any(f.endswith(".npz") for f in os.listdir(path))


def _refuse_unported(args, input_path: str) -> None:
    """Planes of the JAX call_mods that this package does not have yet
    fail here, before any work, instead of running something else."""
    refused = [
        (args.transfer_dtype == "int8", "--transfer_dtype int8"),
        (args.device_resident == "always", "--device_resident always"),
        (args.profile_dir is not None, "--profile_dir"),
        (input_path.endswith(".npz"), ".npz feature inputs"),
        (os.path.isdir(input_path) and _holds_npz(input_path),
         "directories of .npz feature batches"),
    ]
    for hit, what in refused:
        if hit:
            raise ValueError(
                f"{what} is not yet ported to deepsignal_plant_tpu_torch "
                "(the JAX package deepsignal_plant_tpu serves it)")


def call_mods(args) -> CallStats:
    """CLI entry: mirrors reference call_mods(args)
    (call_modifications.py:532)."""
    input_path = os.path.abspath(args.input_path)
    if not os.path.exists(input_path):
        raise ValueError("--input_path does not exist!")
    model_path = os.path.abspath(args.model_path)
    if not os.path.exists(model_path):
        raise ValueError("--model_path is not set right!")
    _refuse_unported(args, input_path)
    device = resolve_device(args.device)
    model_cfg = model_config_from_args(args, device, args.dropout_rate)
    call_cfg = CallConfig(
        device_batch=args.device_batch or CallConfig.device_batch,
        transfer_dtype=("float16" if args.transfer_dtype == "auto"
                        else args.transfer_dtype),
        packed_wire=args.packed_wire,
        num_parse_workers=args.parse_workers)

    print("[main] call_mods starts..")
    t0 = time.time()
    launches0 = dict(fused_lstm.launches)
    engine = CallModsEngine(model_path, model_cfg, call_cfg, device)
    if os.path.isdir(input_path):
        from .extract import extract_to_call_mods
        stats = extract_to_call_mods(engine, input_path, args)
    else:
        stats = engine.run_features_file(input_path, args.result_file,
                                         args.gzip)
    if args.verbose_stages:
        print("[stages] " + json.dumps({
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "compute_dtype": model_cfg.compute_dtype,
            "recurrence": model_cfg.recurrence,
            "transfer_dtype": call_cfg.transfer_dtype,
            "packed_wire": call_cfg.packed_wire,
            "parse_workers": engine._parse_workers(),
            **dataclasses.asdict(stats),
            "sites_per_s": stats.sites_per_s,
            "kernel_launches": {k: v - launches0[k]
                                for k, v in fused_lstm.launches.items()}}))
    print("[main] call_mods costs %.2f seconds.. "
          "(%d sites, %.0f sites/s)" % (time.time() - t0, stats.sites,
                                        stats.sites_per_s))
    if stats.sites:
        print("[main] accuracy vs label column: %.4f "
              "(meaningful only on labeled features)" %
              stats.label_accuracy)
    return stats
