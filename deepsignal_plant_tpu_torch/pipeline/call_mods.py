"""call_mods on a features TSV, a fast5 directory or .npz feature batches
(counterpart of deepsignal_plant_tpu/pipeline/call_mods.py: :40-75,
:106-144, :159-228, :280-310, :352-377, :448-460, :499-506, :677-1011,
:1014-1800, :1803-1918 and :1921-1967; the fast5 directory goes through
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

int8 wire: the float16 route's batches quantized per batch and per field
(means, stds, signals: symmetric, amax/127; the lengths stay float16 and
the codes int8) by the native quantizer; the (3,) float32 scales ride
the upload, and the card multiplies them back in (plain PyTorch: the
JAX package does this multiply in XLA, outside its Pallas kernels). The
read-packed route quantizes the deduplicated base arrays and dequantizes
on the base axis before the window gather; the per-site route (v1
.npz) quantizes the batch's windows. There is no numpy quantizer: a
missing native library fails the run.

.npz inputs (a file, or a directory of batches of one version,
utils/formats.py): v1 takes the per-site route (float32 arrays, cast to
the wire); v2 (per-site float16 wire) is repacked by ``pack_raw_block``
into the read-packed route, as the TSV plane is; v3 (read-packed) goes
straight to it. One loader thread reads them, four files ahead (the
JAX package measured thread pools of .npz readers collapsing).

``--device_resident always``: the same batches, grouped into segments of
k = up to RESIDENT_MAX_CHUNKS batches (k * device_batch rows); a segment
is uploaded as one copy, its batches' forwards run from it, and its
probabilities come back as one copy. Segment s+1's upload runs on the
copy stream while segment s computes. Over several cards each card
holds its shares of a segment's k batches (k * device_batch / cards
rows) as one upload. Each batch sees the forward it
sees when streamed, so the bytes equal the streaming plane's at the same
device_batch.

Local cards (JAX's mesh over ``jax.local_devices()``, P("dp") on the
sites): the engine holds one model replica and one pinned ring and copy
stream per card, rounds ``device_batch`` up to a multiple of the cards
(parallel/mesh.py) and cuts each batch into contiguous per-card shares.
A share of the per-site route is its rows; a share of the read-packed
route is its sites and the base span their windows cover, centres
rebased (JAX replicates the base axis; a span ships the same window
bytes, plus at most seq_len - 1 bases a cut). int8 scales are the
batch's, made before the cut, and go to every share unchanged. Each
card's share runs on that card, the probabilities come back in row
order, and the output is one card's, byte for byte. A card whose share
is empty gets no upload and no launch.

The main thread formats and writes batch k while batch k+1's upload and
forward run on the card. Every kernel launch stays on the main thread
(the model's packed-weight cache and the launch counters are not
thread-safe). There is no fallback: on the card the forward runs the
layer kernel or the run fails, and a failed build of the native library
fails the run.
"""
from __future__ import annotations

import contextlib
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
from ..parallel.dist import host_output_path
from ..parallel.mesh import local_batch_target, shares as card_shares
from ..utils.device import resolve_devices
from ..utils.fastparse import (emit_call_rows_arrays, format_call_block,
                               pack_raw_block, parse_raw_feature_block,
                               quantize_int8)
from ..utils.formats import (feature_npz_paths, load_packed_npz,
                             load_wire_npz, wire_npz_version)
from ..utils.prof import device_trace, stage

#: forward tile: wider batches run the forward in COMPUTE_TILE-row tiles
#: and the ragged tail as one narrow forward, so every row sees the
#: numerics of a forward no wider than this (the JAX package measured
#: bf16 call flips in 16384-wide forwards and none at 4096)
COMPUTE_TILE = 4096
#: batches (or resident segments) on the card at once (uploaded, not yet
#: written out)
INFLIGHT = 2
#: resident plane: at most this many device batches a segment
RESIDENT_MAX_CHUNKS = 32

_TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32}

_V1_WARNING = (
    "[warn] v1 .npz feature batches are DEPRECATED as a call_mods input "
    "(slow per-row string decode): regenerate with extract --w_format "
    "npz_packed (or serve the TSV directly). v1 remains the training/"
    "tools container.")


def forward_tiled(model: ModelBiLSTM, b: Batch) -> torch.Tensor:
    """Inference probabilities (N, num_classes) in <= COMPUTE_TILE-row
    forwards; ceil(N / COMPUTE_TILE) of them."""
    n = b.kmer.shape[0]
    probs = [model(Batch(*(a[lo:lo + COMPUTE_TILE] for a in b)))[1]
             for lo in range(0, n, COMPUTE_TILE)]
    return probs[0] if len(probs) == 1 else torch.cat(probs)


def _quantize_field(a: np.ndarray) -> tuple[np.ndarray, float]:
    """Symmetric int8 quantization of one float16 or float32 array
    (JAX call_mods.py:40-50, without its numpy fallback)."""
    return quantize_int8(np.asarray(a))


def quantize_for_wire(batch: Batch) -> tuple[Batch, np.ndarray]:
    """The int8 wire of a per-site batch (JAX call_mods.py:53-75): means,
    stds and signals quantized per batch and per field, the lengths as
    float16, the codes as int8; plus the (3,) float32 dequant scales."""
    qm, sm = _quantize_field(batch.base_means)
    qs, ss = _quantize_field(batch.base_stds)
    qg, sg = _quantize_field(batch.signals)
    lens = batch.base_signal_lens
    if lens.dtype != np.float16:
        lens = lens.astype(np.float16)
    return (Batch(kmer=np.asarray(batch.kmer, np.int8), base_means=qm,
                  base_stds=qs, base_signal_lens=lens, signals=qg),
            np.array([sm, ss, sg], np.float32))


def quantize_packed(arrays: tuple) -> tuple:
    """The int8 wire of a read-packed batch (JAX call_mods.py:614-625):
    the deduplicated base arrays quantized per batch and per field; the
    scales appended."""
    codes, means, stds, lens, rect, centers = arrays
    qm, sm = _quantize_field(means)
    qs, ss = _quantize_field(stds)
    qr, sr = _quantize_field(rect)
    return (codes, qm, qs, lens, qr, centers,
            np.array([sm, ss, sr], np.float32))


def _dequantize(tensors, scales: torch.Tensor) -> list[torch.Tensor]:
    """int8 means, stds and signals back to float32 on the device (JAX's
    ``x.astype(f32) * scale`` in its jitted step)."""
    return [t.float() * scales[i] for i, t in enumerate(tensors)]


def _persite_wire(fb, wire: str) -> tuple:
    """A FeatureBatch's upload arrays at the per-site route's wire: the
    float32 arrays as they are, cast to float16, or the int8 wire of the
    float16 cast (JAX predict_probs then _predict) with its scales."""
    kmer = np.asarray(fb.kmer, np.int8)
    if wire == "float32":
        return (kmer, fb.base_means, fb.base_stds, fb.base_signal_lens,
                fb.signals)
    b = Batch(kmer, *(np.asarray(a, np.float16) for a in (
        fb.base_means, fb.base_stds, fb.base_signal_lens, fb.signals)))
    if wire == "float16":
        return tuple(b)
    q, scales = quantize_for_wire(b)
    return (*q, scales)


def _estimate_rows(input_path: str, npz_files: list | None) -> int | None:
    """A cheap row-count estimate of a features input (JAX
    call_mods.py:352-377): sites of the first .npz times the files, or
    the TSV's size over its bytes per row in the first 256 KiB. None for
    gzip."""
    if npz_files is not None:
        with np.load(npz_files[0], allow_pickle=False) as z:
            return int(z["labels"].shape[0]) * len(npz_files)
    if input_path.endswith(".gz") or not os.path.isfile(input_path):
        return None
    size = os.path.getsize(input_path)
    if size == 0:
        return 0
    with open(input_path, "rb") as fh:
        sample = fh.read(1 << 18)
    nl = sample.count(b"\n")
    if nl == 0:
        return 1
    return int(size / (len(sample) / nl)) + 1


def resident_k_chunks(est_rows: int | None, target: int) -> int:
    """Device batches a resident segment (JAX _resident_k_chunks): the
    smallest power of two whose segment covers the estimated rows, at
    most RESIDENT_MAX_CHUNKS."""
    k = 1
    est = est_rows or target
    while k * target < est and k < RESIDENT_MAX_CHUNKS:
        k *= 2
    return k


def npz_version(npz_files: list[str]) -> int:
    """The container version of a set of .npz batches (0 = v1, 2, 3);
    a set that mixes versions raises, with the JAX loaders' message."""
    want = wire_npz_version(npz_files[0])
    for path in npz_files[1:]:
        ver = wire_npz_version(path)
        if ver != want:
            raise ValueError(
                f"{path} is wire-format v{ver}, not v{want} — a directory "
                "must not mix wire versions (regenerate with one extract "
                "--w_format)")
    return want


@dataclass
class CallStats:
    sites: int = 0
    batches: int = 0
    # forwards of at most COMPUTE_TILE rows, over every card's shares
    forward_tiles: int = 0
    # rows a batch (a multiple of the cards), and the cards
    device_batch: int = 0
    devices: list[str] = dataclasses.field(default_factory=list)
    seconds: float = 0.0
    # called labels matching the features' label column — meaningful only
    # on labeled features (call_modifications.py:171-173)
    label_correct: int = 0
    # batches and sites by route: read-packed (the float16 and int8 wires;
    # windows gathered on the device) and per-site (the float32 wire and
    # v1 .npz inputs; v2 .npz inputs under --device_resident always)
    packed_batches: int = 0
    packed_sites: int = 0
    persite_batches: int = 0
    persite_sites: int = 0
    # per-base rows uploaded (packed: the deduplicated bases; per-site:
    # seq_len a site) and the bytes of every array uploaded
    bases_uploaded: int = 0
    wire_bytes: int = 0
    # parser threads' seconds in parse + pack, summed over the threads
    # (float16 plane): their ``parse`` spans
    parse_seconds: float | None = None
    # the main thread's seconds in each of its spans (utils/prof.py),
    # which never nest: blocked on the next parsed or loaded block
    # (parse_wait); cutting and concatenating blocks into batches, int8
    # quantization, cutting units into card shares, its waits excluded
    # (batch); staging into the pinned ring, the ring-slot wait and the
    # copy's submission (upload); launching the tiled forward (forward);
    # starting the readback and waiting on the card (readback); row
    # emission, label count and queueing the rows (emit); the writer's
    # drain at the call's end (drain)
    parse_wait_seconds: float = 0.0
    batch_seconds: float = 0.0
    upload_seconds: float = 0.0
    forward_seconds: float = 0.0
    readback_seconds: float = 0.0
    format_seconds: float = 0.0
    drain_seconds: float = 0.0
    # seconds of the call in which no unit was submitted to a card and
    # not yet waited for: the engine gave the cards no work (from the
    # call's start to the first upload, from each wait that leaves
    # nothing in flight to the next upload, from the last wait to the end)
    unfed_seconds: float = 0.0
    # input blocks taken (loaded files, parsed byte blocks, feature
    # batches) and engine units made (a batch, or a resident segment):
    # the ids the spans carry (``block <j>``, ``blocks <a>-<b>``,
    # ``unit <i>``) count from 0 in a call
    blocks: int = 0
    units: int = 0
    # launches of every kernel counter over the call
    # (ops/fused_lstm.py::kernel_launches: K1's and the recurrence's)
    kernel_launches: dict[str, int] = dataclasses.field(
        default_factory=dict)
    # the card's time on the copy stream for the uploads, and on the
    # compute stream for the forwards (from the start of each unit's
    # forwards, its upload arrived and earlier units done, to their end;
    # CUDA events; None on the CPU): the busiest card's, and the
    # forwards' per card
    upload_device_seconds: float | None = None
    forward_device_seconds: float | None = None
    forward_device_seconds_per_card: list[float] | None = None
    # fast5 inputs: files found, and files that failed to read or extract
    fast5_files: int | None = None
    fast5_errors: int | None = None
    # .npz inputs: the container version (0 = v1, 2, 3) and files read
    npz_version: int | None = None
    npz_files: int | None = None
    # --device_resident always: device batches a segment, and segments
    resident_k_chunks: int | None = None
    resident_segments: int | None = None

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
    arrays: tuple                # host arrays in upload order (int8 wire:
    #                              the (3,) float32 scales last)
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
    """Consume blocks from ``fifo`` ([PackedFeatureBlock, consumed,
    block index] deque) into one packed batch: up to ``target`` sites
    whose covering base span fits ``base_budget``. Returns ((codes,
    means, stds, lens, rect, centers), segs, labels, ns, nbase) with
    centers rebased to the batch's base axis."""
    nb = (seq_len - 1) // 2
    segs = []
    cols = {k: [] for k in ("codes", "means", "stds", "lens",
                            "rect", "centers", "labels")}
    ns = nbase = 0
    while fifo and ns < target:
        ent = fifo[0]
        pb, lo = ent[0], ent[1]
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


def _emit_raw_segments(segs, probs: np.ndarray) -> bytes:
    """Output rows of per-site RawFeatureBlock rows (v2 .npz)."""
    out, off = [], 0
    for rb, lo, hi in segs:
        out.append(emit_call_rows_arrays(
            rb.raw, rb.row_starts[lo:hi], rb.info_ends[lo:hi],
            rb.kmer[lo:hi], probs[off:off + hi - lo]))
        off += hi - lo
    return b"".join(out)


@dataclass
class _Share:
    """One card's rows of a batch of its unit."""
    batch: int                   # the batch's index in the unit
    route: str
    arrays: tuple                # upload order, as _Batch.arrays
    n: int                       # sites
    bases: int                   # per-base rows uploaded


def _share(b: _Batch, index: int, lo: int, hi: int, seq_len: int
           ) -> _Share:
    """Sites [lo, hi) of batch ``b`` (of unit position ``index``): on the
    per-site route their rows; on the read-packed route the base span of
    their windows, centres rebased to it (centres rise within a batch).
    int8 scales, the batch's, go unchanged."""
    if lo == 0 and hi == b.n:
        return _Share(index, b.route, b.arrays, b.n, b.bases)
    if b.route == "persite":
        arrays = tuple(a[lo:hi] for a in b.arrays[:5]) + b.arrays[5:]
        return _Share(index, b.route, arrays, hi - lo, (hi - lo) * seq_len)
    codes, means, stds, lens, rect, centers, *scales = b.arrays
    nb = (seq_len - 1) // 2
    b0 = int(centers[lo]) - nb
    b1 = int(centers[hi - 1]) + nb + 1
    arrays = (*(a[b0:b1] for a in (codes, means, stds, lens, rect)),
              centers[lo:hi] - np.int32(b0), *scales)
    return _Share(index, b.route, arrays, hi - lo, b1 - b0)


class _Slot:
    """One entry of the pinned ring: the upload buffer of a batch (or a
    resident segment), its probabilities' readback buffer, and the events
    that guard and time them."""
    __slots__ = ("host", "out", "up0", "copied", "fwd0", "fwd1", "done")

    def __init__(self):
        self.host = self.out = None
        self.up0 = self.copied = self.fwd0 = self.fwd1 = self.done = None


class _DeviceFeed:
    """Moves batches to the device and their probabilities back.

    On the card each unit's arrays (one batch, or a resident segment's
    batches) are copied into one pinned buffer of a ring of INFLIGHT + 1
    slots and uploaded by one non-blocking copy on a copy stream; the
    compute stream waits for that copy's event and cuts the upload into
    the arrays. The probabilities come back by a non-blocking copy into
    the slot's pinned output buffer behind an event. A slot is refilled
    only after the events of its last unit have fired. Every event and
    copy names this card's streams, so a feed of card 1 is guarded
    whatever device is current. On the CPU nothing is pinned: arrays
    pass through as tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.upload_ms = 0.0
        self.forward_ms = 0.0
        self._k = 0
        if self.cuda:
            self._copy = torch.cuda.Stream(device)
            self._slots = [_Slot() for _ in range(INFLIGHT + 1)]

    def upload(self, arrays: tuple) -> tuple[list[torch.Tensor], _Slot | None]:
        if not self.cuda:
            # .npz arrays are read-only views of the file's bytes
            return [torch.from_numpy(np.array(a) if not a.flags.writeable
                                     else np.ascontiguousarray(a))
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
        slot.up0, slot.copied, slot.fwd0, slot.fwd1 = (
            torch.cuda.Event(enable_timing=True) for _ in range(4))
        slot.done = torch.cuda.Event()
        with torch.cuda.stream(self._copy):
            slot.up0.record(self._copy)
            dev = slot.host[:total].to(self.device, non_blocking=True)
            slot.copied.record(self._copy)
        compute.wait_event(slot.copied)
        slot.fwd0.record(compute)
        dev.record_stream(compute)
        return [dev[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).view(
            a.shape) for a, o in zip(arrays, offs)], slot

    def readback(self, probs: torch.Tensor, slot: _Slot | None):
        """Start the probabilities' copy to the host; ``wait`` ends it.
        The caller runs it with this card current: the copy goes on the
        card's current stream."""
        if not self.cuda:
            return probs.numpy()
        compute = torch.cuda.current_stream(self.device)
        slot.fwd1.record(compute)
        n = probs.shape[0]
        if slot.out is None or slot.out.shape[0] < n:
            slot.out = torch.empty(probs.shape, dtype=probs.dtype,
                                   pin_memory=True)
        out = slot.out[:n]
        out.copy_(probs, non_blocking=True)
        slot.done.record(compute)
        return out

    def wait(self, out, slot: _Slot | None) -> np.ndarray:
        """The probabilities on the host, once their copy has finished;
        valid until the slot is reused."""
        if not self.cuda:
            return out
        slot.done.synchronize()
        self.upload_ms += slot.up0.elapsed_time(slot.copied)
        self.forward_ms += slot.fwd0.elapsed_time(slot.fwd1)
        return out.numpy()


def _units(batches: Iterator[_Batch], k: int, stats: CallStats
           ) -> Iterator[list[_Batch]]:
    """Consecutive batches in groups of ``k`` (the last one shorter),
    counted in ``stats.units``: while a unit's batches are made, that
    count is the unit's index."""
    unit: list[_Batch] = []
    try:
        for b in batches:
            unit.append(b)
            if len(unit) == k:
                stats.units += 1
                yield unit
                unit = []
        if unit:
            stats.units += 1
            yield unit
    finally:
        batches.close()     # stops the parser threads after an error


def _waited(blocks: Iterator, stats: CallStats) -> Iterator[tuple]:
    """(index, block) of each input block in order, each waited for in a
    ``parse_wait`` span and counted in ``stats.blocks``."""
    while True:
        with stage("parse_wait", stats, "parse_wait_seconds"):
            block = next(blocks, None)
        if block is None:
            return
        stats.blocks += 1
        yield stats.blocks - 1, block


def _batch_span(stats: CallStats):
    """The ``batch`` span of the unit being made."""
    return stage("batch", stats, "batch_seconds", f"unit {stats.units}")


def _blocks_span(first: int, last: int):
    """A child of a ``batch`` span: the blocks its batch came from."""
    return stage(f"blocks {first}-{last}")


class CallModsEngine:
    """Loads a checkpoint once onto each of its cards and calls feature
    files. ``device``: a device, a list of devices (one model replica
    each; a card may repeat, as two replicas on one card), or a
    ``--device`` string (utils/device.resolve_devices: None or "cuda"
    is every visible card outside a launch)."""

    def __init__(self, model_path: str, model_cfg: ModelConfig,
                 call_cfg: CallConfig | None = None,
                 device: torch.device | str | list | None = None):
        if isinstance(device, (list, tuple)):
            self.devices = [torch.device(d) for d in device]
        elif isinstance(device, torch.device):
            self.devices = [device]
        else:
            self.devices = resolve_devices(device)
        if not self.devices:
            raise ValueError("CallModsEngine needs at least one device")
        self.device = self.devices[0]
        self.model_cfg = model_cfg
        self.call_cfg = call_cfg or CallConfig()
        self.device_batch = local_batch_target(self.call_cfg.device_batch,
                                               len(self.devices))
        params = load_any_checkpoint(model_path, self.model_cfg)
        # a replica per card, each with its own packed-weight caches
        self.models = [ModelBiLSTM.from_params(params, self.model_cfg, d)
                       for d in self.devices]
        self.model = self.models[0]
        self._warned_v1 = False
        native.load()    # build the parser now: a failed build fails here

    def run_features_file(self, input_path: str, result_path: str,
                          is_gzip: bool = False) -> CallStats:
        """A features TSV (plain or .gz), an .npz file or a directory of
        .npz batches -> call_mods TSV (reference else-branch,
        call_modifications.py:584-636; JAX run_features_file). The
        call's spans run under a ``run_features_file`` span."""
        t0 = time.perf_counter()
        stats = self._new_stats()
        with stage("run_features_file"):
            npz_files = feature_npz_paths(input_path)
            if npz_files is not None:
                stats.npz_version = npz_version(npz_files)
                stats.npz_files = len(npz_files)
            k = 1
            if self.call_cfg.device_resident == "always":
                self._check_resident_input(input_path, stats)
                batches = self._resident_batches(input_path, npz_files,
                                                 stats)
                k = resident_k_chunks(_estimate_rows(input_path, npz_files),
                                      stats.device_batch)
                stats.resident_k_chunks = k
                stats.resident_segments = 0
            elif npz_files is not None:
                batches = self._npz_batches(input_path, npz_files, stats)
            elif self.call_cfg.transfer_dtype == "float32":
                batches = self._persite_file_batches(input_path, stats)
            else:
                batches = self._packed_plane_batches(input_path, stats)
            self._run_fast(_units(batches, k, stats), result_path, is_gzip,
                           stats, t0)
        return stats

    def _new_stats(self) -> CallStats:
        return CallStats(device_batch=self.device_batch,
                         devices=[str(d) for d in self.devices])

    def _parse_workers(self) -> int:
        return self.call_cfg.num_parse_workers or default_parse_workers()

    def _npz_batches(self, input_path: str, npz_files: list[str],
                     stats: CallStats) -> Iterator[_Batch]:
        """The .npz planes (JAX run_features_file :1838-1862): v3 into
        the read-packed route, v2 repacked into it, v1 on the per-site
        route (with JAX's one-time deprecation line). v2 and v3 hold
        float16 on disk, so the float32 wire gives them their float16
        values, as in JAX."""
        if stats.npz_version == 0:
            if not self._warned_v1:
                self._warned_v1 = True
                print(_V1_WARNING)
            yield from self._persite_file_batches(input_path, stats)
            return
        load = (load_packed_npz if stats.npz_version == 3
                else lambda f: pack_raw_block(load_wire_npz(f)))
        yield from self._loaded_packed_batches(load, npz_files, stats)

    def _loaded_packed_batches(self, load, npz_files, stats: CallStats
                               ) -> Iterator[_Batch]:
        """Read-packed batches from containers that ``load`` turns into
        PackedFeatureBlocks: one loader thread, four files ahead (JAX
        _run_fast_wire_npz)."""
        def timed(job):
            j, f = job
            with stage("parse", tag=f"block {j}"):
                t = time.perf_counter()
                pb = load(f)
                return pb, time.perf_counter() - t

        blocks = bounded_thread_map(timed, enumerate(npz_files), workers=1,
                                    depth=4)
        yield from self._timed_packed_batches(blocks, stats)

    def _packed_plane_batches(self, input_path: str, stats: CallStats
                              ) -> Iterator[_Batch]:
        """The float16 (and int8) plane of a features TSV (JAX
        _run_fast_tsv and _run_fast_packed): parser threads parse and
        pack 8 MiB byte blocks into the read-packed wire."""
        cfg = self.model_cfg
        L, S = cfg.seq_len, cfg.signal_len

        def parse_and_pack(job):
            j, raw = job
            with stage("parse", tag=f"block {j}"):
                t = time.perf_counter()
                pb = pack_raw_block(parse_raw_feature_block(raw, L, S))
                return pb, time.perf_counter() - t

        pw = self._parse_workers()
        blocks = bounded_thread_map(
            parse_and_pack, enumerate(iter_byte_blocks(input_path, 8 << 20)),
            workers=pw, depth=2 * pw)
        yield from self._timed_packed_batches(blocks, stats)

    def _timed_packed_batches(self, blocks, stats: CallStats
                              ) -> Iterator[_Batch]:
        """Packed batches from (PackedFeatureBlock, seconds) pairs made
        ahead in other threads, their seconds summed into
        ``parse_seconds``."""
        blocks = PrefetchIterator(blocks, depth=4)
        stats.parse_seconds = 0.0

        def timed():
            for pb, dt in blocks:
                stats.parse_seconds += dt
                yield pb
        try:
            yield from self._packed_batches(_waited(timed(), stats), stats)
        finally:
            blocks.close()

    def _packed_batches(self, blocks: Iterator, stats: CallStats
                        ) -> Iterator[_Batch]:
        """Read-packed batches from (index, PackedFeatureBlock) pairs
        (``_waited``): a batch closes when it holds ``device_batch`` sites
        or its base budget is full. The int8 wire quantizes each batch's
        base arrays here."""
        cfg = self.model_cfg
        L, S = cfg.seq_len, cfg.signal_len
        target = stats.device_batch
        base_budget = 1 << (target * L - 1).bit_length()
        quant = self.call_cfg.transfer_dtype == "int8"
        fifo: deque = deque()       # [pb, consumed sites, block index]
        pending = 0
        exhausted = False
        while True:
            while not exhausted and pending < target:
                j, pb = next(blocks, (None, None))
                if pb is None:
                    exhausted = True
                    break
                if pb.n:
                    fifo.append([_check_packed_block(pb, L, S), 0, j])
                    pending += pb.n
            if not fifo:
                return
            with _batch_span(stats):
                index = {id(ent[0]): ent[2] for ent in fifo}
                arrays, segs, labels, ns, nbase = _take_packed_span(
                    fifo, target, base_budget, L)
                with _blocks_span(index[id(segs[0][0])],
                                  index[id(segs[-1][0])]):
                    pending -= ns
                    if quant:
                        arrays = quantize_packed(arrays)
                    batch = _Batch("packed", arrays, ns, nbase, labels,
                                   partial(_emit_segments, segs))
            yield batch

    def _persite_file_batches(self, input_path: str, stats: CallStats
                              ) -> Iterator[_Batch]:
        """The per-site route of a features TSV (the native parser at
        float32 in parser threads) or of v1 .npz batches, in batches of
        ``device_batch`` rows."""
        cfg = self.model_cfg
        fbs = PrefetchIterator(batches_from_features_file(
            input_path, stats.device_batch, cfg.seq_len, cfg.signal_len,
            self._parse_workers(), out_dtype="float32"), depth=4)
        try:
            yield from self._persite_batches(
                ((j, j, fb) for j, fb in _waited(fbs, stats)), stats)
        finally:
            fbs.close()

    def _persite_batches(self, fbs: Iterator, stats: CallStats
                         ) -> Iterator[_Batch]:
        """Per-site batches from (first block, last block, FeatureBatch)
        triples of float32 batches of at most ``device_batch`` rows, at
        the engine's wire."""
        L = self.model_cfg.seq_len
        wire = self.call_cfg.transfer_dtype
        for first, last, fb in fbs:
            with _batch_span(stats), _blocks_span(first, last):
                arrays = _persite_wire(fb, wire)

            def emit(probs, fb=fb) -> bytes:
                return format_call_block(fb.sampleinfo, probs,
                                         fb.kmer).encode()
            yield _Batch("persite", arrays, len(fb), len(fb) * L,
                         fb.labels, emit)

    def _raw_persite_batches(self, blocks: Iterator, stats: CallStats
                             ) -> Iterator[_Batch]:
        """Per-site float16 batches of ``device_batch`` rows from
        (index, RawFeatureBlock) pairs (v2 .npz, ``_waited``), rows
        emitted from the blocks' info bytes."""
        L = self.model_cfg.seq_len
        target = stats.device_batch
        fifo: deque = deque()       # [rb, consumed rows, block index]
        pending = 0
        exhausted = False

        def cat(segs, name, dt):
            parts = [np.asarray(getattr(rb, name)[lo:hi], dt)
                     for rb, lo, hi in segs]
            return parts[0] if len(parts) == 1 else np.concatenate(parts)
        while True:
            while not exhausted and pending < target:
                j, rb = next(blocks, (None, None))
                if rb is None:
                    exhausted = True
                elif rb.n:
                    fifo.append([rb, 0, j])
                    pending += rb.n
            if not fifo:
                return
            with _batch_span(stats):
                segs, need, first = [], min(target, pending), fifo[0][2]
                pending -= need
                while need:
                    ent = fifo[0]
                    rb, lo, last = ent
                    hi = min(rb.n, lo + need)
                    segs.append((rb, lo, hi))
                    need -= hi - lo
                    if hi == rb.n:
                        fifo.popleft()
                    else:
                        ent[1] = hi
                with _blocks_span(first, last):
                    arrays = tuple(cat(segs, name, dt) for name, dt in (
                        ("kmer", np.int8), ("means", np.float16),
                        ("stds", np.float16), ("slens", np.float16),
                        ("signals", np.float16)))
                    n = len(arrays[0])
                    batch = _Batch("persite", arrays, n, n * L,
                                   cat(segs, "labels", np.int32),
                                   partial(_emit_raw_segments, segs))
            yield batch

    @staticmethod
    def _check_resident_input(input_path: str, stats: CallStats) -> None:
        """JAX's input rules of ``--device_resident always``
        (_run_features_file_resident): v1 .npz and gzip TSVs raise, before
        any output is opened."""
        if stats.npz_version == 0:
            raise ValueError(
                "--device_resident does not serve v1 .npz features; "
                "regenerate with extract --w_format npz_wire/npz_packed "
                "or TSV.")
        if stats.npz_version is None and (
                not os.path.isfile(input_path)
                or input_path.endswith(".gz")):
            raise ValueError(
                "--device_resident serves plain features TSV or wire-"
                "format .npz inputs (got {})".format(input_path))

    def _resident_batches(self, input_path: str, npz_files, stats: CallStats
                          ) -> Iterator[_Batch]:
        """The batches of ``--device_resident always``: a plain TSV
        through the packed bridge (the float32 wire: its per-site float32
        batches, the streaming plane's), v3 packed (int8: quantized per
        batch), v2 per-site at the float16 wire (JAX does not quantize
        it)."""
        if npz_files is None:
            if self.call_cfg.transfer_dtype == "float32":
                yield from self._persite_file_batches(input_path, stats)
            else:
                yield from self._packed_plane_batches(input_path, stats)
        elif stats.npz_version == 3:
            yield from self._loaded_packed_batches(load_packed_npz,
                                                   npz_files, stats)
        else:
            blocks = PrefetchIterator(bounded_thread_map(
                load_wire_npz, npz_files, workers=1, depth=4), depth=4)
            try:
                yield from self._raw_persite_batches(_waited(blocks, stats),
                                                     stats)
            finally:
                blocks.close()

    def run_blocks(self, blocks: Iterator, result_path: str,
                   is_gzip: bool = False, packed: bool = True
                   ) -> CallStats:
        """Call input blocks in order: PackedFeatureBlocks (``packed``,
        the float16 and int8 planes) or float32 FeatureBatches of any
        size (the per-site route). The fused fast5 path feeds this
        (pipeline/extract.py::extract_to_call_mods). The call's spans run
        under a ``run_blocks`` span."""
        t0 = time.perf_counter()
        stats = self._new_stats()
        with stage("run_blocks"):
            blocks = _waited(iter(blocks), stats)
            if packed:
                batches = self._packed_batches(blocks, stats)
            else:
                batches = self._persite_batches(
                    _rechunk(blocks, stats.device_batch, stats), stats)
            self._run_fast(_units(batches, 1, stats), result_path, is_gzip,
                           stats, t0)
        return stats

    def _device_batch(self, route: str, tensors: list[torch.Tensor]
                      ) -> Batch:
        """The model's Batch from uploaded arrays: int8 fields
        dequantized (on the packed route on the base axis, before the
        gather, as JAX's _build_packed_step), then the packed route's
        windows gathered from the base axis (JAX's jnp.take)."""
        if route == "packed":
            codes, means, stds, lens, rect, centers, *scales = tensors
            if scales:
                means, stds, rect = _dequantize((means, stds, rect),
                                                scales[0])
            nb = (self.model_cfg.seq_len - 1) // 2
            win = centers.long()[:, None] + torch.arange(
                -nb, nb + 1, device=centers.device)[None, :]
            kmer, means, stds, lens, sig = (a[win] for a in (
                codes, means, stds, lens, rect))
        else:
            kmer, means, stds, lens, sig, *scales = tensors
            if scales:
                means, stds, sig = _dequantize((means, stds, sig),
                                               scales[0])
        return Batch(kmer=kmer, base_means=means.float(),
                     base_stds=stds.float(), base_signal_lens=lens.float(),
                     signals=sig.float())

    def _split(self, unit: list[_Batch]) -> list[list[_Share]]:
        """Each card's shares of a unit's batches (parallel/mesh.py
        ``shares``); a card gets nothing for a batch whose share is
        empty."""
        n, L = len(self.devices), self.model_cfg.seq_len
        per_card: list[list[_Share]] = [[] for _ in range(n)]
        for i, b in enumerate(unit):
            for card, (lo, hi) in enumerate(card_shares(
                    b.n, self.device_batch, n)):
                if hi > lo:
                    per_card[card].append(_share(b, i, lo, hi, L))
        return per_card

    def _run_fast(self, units: Iterator[list[_Batch]], result_path: str,
                  is_gzip: bool, stats: CallStats, t0: float) -> None:
        """Upload, forward, readback and row emission of every unit (one
        batch, or a resident segment of batches; JAX _run_fast's dispatch
        loop), INFLIGHT units on the cards at once: unit k is formatted
        and written while unit k+1 runs. A unit is one upload and one
        readback a card that has rows in it. Ends the call that started
        at ``t0`` (``time.perf_counter``): its seconds, the seconds it
        left the cards without a unit in flight, its kernel launches."""
        launches0 = fused_lstm.kernel_launches()
        feeds = [_DeviceFeed(d) for d in self.devices]
        writer = AsyncWriter(result_path, is_gzip)
        inflight: deque = deque()
        unfed = t0      # no unit in flight since; None while one is

        def finish():
            nonlocal unfed
            waited = self._finish(*inflight.popleft(), writer, stats)
            if not inflight:
                unfed = waited
        try:
            for u, unit in enumerate(units):
                with stage("batch", stats, "batch_seconds", f"unit {u}"):
                    per_card = self._split(unit)
                work, submitted = [], []
                for feed, model, shares in zip(feeds, self.models,
                                               per_card):
                    if shares:
                        w, t = self._launch(feed, model, shares, stats, u)
                        work.append(w)
                        submitted.append(t)
                inflight.append((u, unit, work))
                if unfed is not None and submitted:
                    stats.unfed_seconds += submitted[0] - unfed
                    unfed = None
                if len(inflight) == INFLIGHT:
                    finish()
            while inflight:
                finish()
        finally:
            units.close()       # stops the parser threads after an error
            with stage("drain", stats, "drain_seconds"):
                writer.close()
        end = time.perf_counter()
        stats.seconds = end - t0
        if unfed is not None:
            stats.unfed_seconds += end - unfed
        stats.kernel_launches = fused_lstm.kernel_launches_since(launches0)
        if feeds[0].cuda:
            stats.upload_device_seconds = max(f.upload_ms
                                              for f in feeds) / 1e3
            stats.forward_device_seconds_per_card = [f.forward_ms / 1e3
                                                     for f in feeds]
            stats.forward_device_seconds = max(
                stats.forward_device_seconds_per_card)

    def _launch(self, feed: _DeviceFeed, model: ModelBiLSTM,
                shares: list[_Share], stats: CallStats, u: int
                ) -> tuple[tuple, float]:
        """One card's shares of unit ``u``, on that card (made current for
        its kernels, streams and events): one upload, a tiled forward a
        share on its replica, and the readback started. Returns the work
        to finish and when its upload was submitted
        (``time.perf_counter``)."""
        tag = f"unit {u}"
        with (torch.cuda.device(feed.device) if feed.cuda
              else contextlib.nullcontext()):
            with stage("upload", stats, "upload_seconds", tag):
                for s in shares:
                    stats.bases_uploaded += s.bases
                    stats.wire_bytes += sum(a.nbytes for a in s.arrays)
                    stats.forward_tiles += -(-s.n // COMPUTE_TILE)
                tensors, slot = feed.upload(
                    tuple(a for s in shares for a in s.arrays))
            submitted = time.perf_counter()
            with stage("forward", stats, "forward_seconds", tag), \
                    torch.inference_mode():
                probs, off = [], 0
                for s in shares:
                    probs.append(forward_tiled(model, self._device_batch(
                        s.route, tensors[off:off + len(s.arrays)])))
                    off += len(s.arrays)
                probs = probs[0] if len(probs) == 1 else torch.cat(probs)
            with stage("readback", stats, "readback_seconds", tag):
                out = feed.readback(probs, slot)
        return (feed, out, slot, shares), submitted

    @staticmethod
    def _finish(u: int, unit: list[_Batch], work: list,
                writer: AsyncWriter, stats: CallStats) -> float:
        """Wait for every card's probabilities of unit ``u``, put each
        batch's back in row order, emit and write its rows. Returns when
        the wait returned (``time.perf_counter``)."""
        tag = f"unit {u}"
        parts: list[list[np.ndarray]] = [[] for _ in unit]
        with stage("readback", stats, "readback_seconds", tag):
            for feed, out, slot, shares in work:
                probs, off = feed.wait(out, slot), 0
                for s in shares:
                    parts[s.batch].append(probs[off:off + s.n])
                    off += s.n
        waited = time.perf_counter()
        with stage("emit", stats, "format_seconds", tag):
            rows = []
            for b, p in zip(unit, parts):
                p = p[0] if len(p) == 1 else np.concatenate(p)
                rows.append(b.emit(p))
                called = p[:, 1] > p[:, 0]
                stats.label_correct += int((called == (b.labels == 1)).sum())
                stats.sites += b.n
                stats.batches += 1
                if b.route == "packed":
                    stats.packed_batches += 1
                    stats.packed_sites += b.n
                else:
                    stats.persite_batches += 1
                    stats.persite_sites += b.n
            writer.write(b"".join(rows))
            if stats.resident_segments is not None:
                stats.resident_segments += 1
        return waited


def _rechunk(blocks: Iterator, target: int, stats: CallStats) -> Iterator:
    """(index, FeatureBatch) blocks of any size re-cut into
    ``target``-row batches (the last one shorter), in order, in ``batch``
    spans: (first block, last block, batch) triples, the blocks its rows
    came from."""
    asm = BatchAssembler(target)
    held: deque = deque()       # [block index, rows not yet cut]

    def cut(fb) -> tuple:
        first, n = held[0][0], len(fb)
        while n:
            ent = held[0]
            k = min(n, ent[1])
            ent[1] -= k
            n -= k
            last = ent[0]
            if not ent[1]:
                held.popleft()
        return first, last, fb
    for j, fb in blocks:
        with _batch_span(stats):
            if len(fb):
                asm.add(fb)
                held.append([j, len(fb)])
            full = []
            while (b := asm.pop_full()) is not None:
                full.append(cut(b))
        yield from full
    with _batch_span(stats):
        rest = asm.pop_rest()
        rest = rest if rest is None else cut(rest)
    if rest is not None:
        yield rest


def call_mods(args) -> CallStats:
    """CLI entry: mirrors reference call_mods(args)
    (call_modifications.py:532)."""
    input_path = os.path.abspath(args.input_path)
    if not os.path.exists(input_path):
        raise ValueError("--input_path does not exist!")
    model_path = os.path.abspath(args.model_path)
    if not os.path.exists(model_path):
        raise ValueError("--model_path is not set right!")
    # every visible card outside a launch (JAX's local devices), the
    # rank's card under one
    devices = resolve_devices(args.device)
    device = devices[0]
    model_cfg = model_config_from_args(args, device, args.dropout_rate)
    call_cfg = CallConfig(
        device_batch=args.device_batch or CallConfig.device_batch,
        transfer_dtype=("float16" if args.transfer_dtype == "auto"
                        else args.transfer_dtype),
        packed_wire=args.packed_wire,
        num_parse_workers=args.parse_workers,
        device_resident=args.device_resident)

    print("[main] call_mods starts..")
    t0 = time.time()
    engine = CallModsEngine(model_path, model_cfg, call_cfg, devices)
    # under a multi-process launch each rank writes <root>.host<RANK><ext>
    # (a fast5 directory is shared out over ranks; a features input is
    # called whole by every rank, as in the JAX package)
    result_file = host_output_path(args.result_file)
    with device_trace(args.profile_dir, device.type == "cuda"):
        if os.path.isdir(input_path) and \
                feature_npz_paths(input_path) is None:
            from .extract import extract_to_call_mods
            stats = extract_to_call_mods(engine, input_path, args,
                                         result_file)
        else:  # a features TSV, an .npz file or a directory of them
            stats = engine.run_features_file(input_path, result_file,
                                             args.gzip)
    if args.verbose_stages:
        print("[stages] " + json.dumps({
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "compute_dtype": model_cfg.compute_dtype,
            "recurrence": model_cfg.recurrence,
            "transfer_dtype": call_cfg.transfer_dtype,
            "packed_wire": call_cfg.packed_wire,
            "device_resident": call_cfg.device_resident,
            "parse_workers": engine._parse_workers(),
            **dataclasses.asdict(stats),
            "sites_per_s": stats.sites_per_s}))
    print("[main] call_mods costs %.2f seconds.. "
          "(%d sites, %.0f sites/s)" % (time.time() - t0, stats.sites,
                                        stats.sites_per_s))
    if stats.sites:
        print("[main] accuracy vs label column: %.4f "
              "(meaningful only on labeled features)" %
              stats.label_accuracy)
    return stats
