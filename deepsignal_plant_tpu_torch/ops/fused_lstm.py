"""Fused BiLSTM layer: the wrapper of the CUDA kernels csrc/fused_bilstm.cu
(counterpart of deepsignal_plant_tpu/ops/pallas_fused.py:104-121 and
:282-330, which run the Pallas kernel ``_fused_kernel``).

Time-major contract, as in the JAX package: inputs (T, B, F) — one array
or the (fwd, bwd) halves of the previous layer, which the kernel reads
against row-split W_ih rows — and outputs (ys_f, ys_b), each (T, B, H) in
true time, or (1, B, H) final states when ``seq_out`` is False.

Two routes, one per compute dtype:

- bfloat16 (the main path): one launch a layer, input projection inside
  the time loop, over weights packed once per model (``packed_weights``
  caches them on the layer module), of one of two kernels by
  ``k1_bf16_plan`` (a rule of F, H and B):
  ``fused_bilstm_bf16_wgmma``, wgmma in 64-row blocks, wherever it fits
  (H <= 256 and its shared memory), in one of two designs: the weights
  resident in shared memory for the launch (``pack_weights_resident``;
  F <= 32, H <= 128: the branches), or streamed by TMA bulk copies into
  a ring of tiles a warpgroup (``pack_weights_wgmma``'s stream order; the
  comb layers); ``fused_bilstm_bf16``, the mma.sync kernel
  (``pack_weights``), everywhere else;
- float32 (exact-parity runs): one of three routes per layer, by
  ``f32_route``. The narrow route (``layer_f32_narrow``,
  ``fused_bilstm_f32_narrow``) is one launch of the narrow kernel: the
  layers of at most 16 input features (the seq and signal branches' 7
  and 16) at H = 128 and 256, from 256 rows up, the projection inside
  the time loop, 3xTF32 mma.sync over [W_ih; W_hh] slices resident
  across a thread-block cluster (packed once per model by
  ``pack_narrow_weights``, cached by ``packed_narrow_weights``) on
  ``narrow_plan``'s clusters and row tiles. The split route
  (``layer_f32_split``) is two launches: the input projection out of
  the time loop, one 3xTF32 wgmma product over all T*B rows
  (``fused_bilstm_proj_f32``, csrc/fused_bilstm.cu) into K2's xproj
  (T, 2, B, 4H), over W_ih packed once per model in tf32 hi and lo planes
  (``pack_proj_weights``, cached by ``packed_proj_weights``); then
  ops/recurrence.py::lstm_recurrence_k1 storing h as K1 does, on the
  kernel ``k1_rec_plan`` picks: K1's wgmma recurrence over W_hh packed
  once per model in tf32 hi and lo planes (``pack_rec_weights``, cached
  by ``packed_rec_weights``; ``fused_bilstm_rec_f32_wgmma``: call_mods'
  4096-row tiles), K2's float32 cluster kernel (``fused_bilstm_rec_f32``)
  or its streaming kernel (``fused_bilstm_rec_f32_stream``). The in-loop
  route (``layer_f32_inloop``, ``fused_bilstm_f32_inloop``: CUDA-core
  FMAs, the projection inside the time loop) takes the narrow layers the
  narrow kernel does not, at batches that fill the card.

K1's launches all count here, its recurrence's too, not in
ops/recurrence.py's counters, which count the training path.

A CPU tensor takes the plain version (ops/lstm.py). A CUDA tensor
launches the kernels, or raises: there is no fallback on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import torch

from . import _build
from . import lstm as plain
from . import recurrence as _rec
from .lstm import bilstm_layer as bilstm_layer_plain

#: launches of each kernel since the last reset (set an entry to 0 to
#: count a run); launches that raise are not counted. A bfloat16 layer
#: launches one of its two kernels; a float32 layer the narrow or the
#: in-loop kernel, or the projection kernel and one of the recurrence's
#: two (so the narrow, in-loop and projection counts sum to the float32
#: layers run)
launches = {"fused_bilstm_bf16_wgmma": 0, "fused_bilstm_bf16": 0,
            "fused_bilstm_f32_narrow": 0, "fused_bilstm_f32_inloop": 0,
            "fused_bilstm_proj_f32": 0, "fused_bilstm_rec_f32": 0,
            "fused_bilstm_rec_f32_stream": 0,
            "fused_bilstm_rec_f32_wgmma": 0}


def kernel_launches() -> dict:
    """K1's launch counters and the recurrence's (ops/recurrence.py), as
    one snapshot."""
    return {**launches, **_rec.launches}


def kernel_launches_since(before: dict) -> dict:
    """Launches of every kernel counter since the ``before`` snapshot
    (``kernel_launches()``)."""
    return {k: v - before[k] for k, v in kernel_launches().items()}


_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HIDDEN = 512


def packed_for(F: int, H: int, B: int) -> str:
    """The packing of the bfloat16 kernel a layer takes (k1_bf16_plan):
    "resident" (pack_weights_resident) or "wgmma" (pack_weights_wgmma)
    for the wgmma kernel's two designs, "mma" (pack_weights) for the
    mma.sync kernel."""
    plan = k1_bf16_plan(F, H, B)
    if plan is None:
        return "mma"
    return "resident" if plan[0] == WG_RESIDENT else "wgmma"


def padded_k(F: int, H: int) -> int:
    """K of the packed weights: F + H rounded up to the kernel's k32."""
    return -(-(F + H) // 32) * 32


@torch.no_grad()
def pack_weights(w_ih: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The bfloat16 kernel's weights: (2, 4H, Kp) bf16 with
    wt[d, n, k] = cat(w_ih[d], w_hh[d])[k, n] for k < F + H and zeros up
    to Kp = padded_k(F, H). w_ih (2, F, 4H), w_hh (2, H, 4H), any float
    dtype. A layout transform in plain tensor ops."""
    F, H = w_ih.shape[1], w_hh.shape[1]
    w = torch.cat([w_ih, w_hh], dim=1).to(torch.bfloat16)   # (2, F+H, 4H)
    wt = w.new_zeros((2, 4 * H, padded_k(F, H)))
    wt[:, :, :F + H] = w.transpose(1, 2)
    return wt


# the wgmma kernel (csrc/fused_bilstm.cu), two designs (the plan's kind):
# WG_STREAMED, weight tiles of 128 packed columns x 64 K (16 KB) streamed
# into a ring of WG_MAX_STAGES at most a consumer warpgroup (rings of 4-6
# were slower on the H100, PERF.md), beside one h buffer, one or two x
# buffers (K slabs of 64, 8 KB each), 12 barriers of 8 bytes and 1,024
# bytes of alignment (the kernel's wg_fixed_smem);
# WG_RESIDENT, a direction's weights resident (x's K padded to RS_KX),
# where F <= RS_MAX_F and H <= RS_MAX_H. 64-row blocks either way; a
# launch whose plan outgrows a block's shared memory raises.
WG_STREAMED, WG_RESIDENT = 0, 1
WG_ROWS, WG_K, WG_SLAB_BYTES, WG_TILE_BYTES = 64, 64, 8192, 16384
WG_MAX_STAGES, WG_MAX_H, WG_BARRIER_BYTES = 3, 256, 2 * 2 * 3 * 8
RS_KX, RS_MAX_F, RS_MAX_H = 32, 32, 128
RS_XTILE_BYTES, RS_XBUF_BYTES = 128 * RS_KX * 2, WG_ROWS * RS_KX * 2
_MAX_SMEM = 232_448                       # a block's, on Hopper


def wgmma_dims(F: int, H: int) -> tuple[int, int]:
    """(x slabs, chunks a warpgroup) of the wgmma kernel: ceil(F / 64) and
    ceil(H / 64) (H padded to Hp = 64 * chunks; the h slabs are as many as
    the chunks)."""
    return -(-F // WG_K), -(-H // 64)


def _wgmma_fixed_smem(F: int, H: int, x_buffers: int) -> int:
    nkx, nch = wgmma_dims(F, H)
    return (x_buffers * nkx + nch) * WG_SLAB_BYTES + \
        WG_BARRIER_BYTES + 1024


def resident_smem(H: int) -> int:
    """Shared-memory bytes of the resident design at hidden size H (the
    kernel's wg_res_smem): a direction's weights (each warpgroup's chunks:
    W_ih's 128 x RS_KX tile, then W_hh's 128 x 64 tiles), two h buffers,
    two x buffers, one barrier and 1,024 bytes of alignment."""
    nch = -(-H // 64)
    return 2 * nch * (RS_XTILE_BYTES + nch * WG_TILE_BYTES) + \
        2 * nch * WG_SLAB_BYTES + 2 * RS_XBUF_BYTES + 8 + 1024


def wgmma_stages(F: int, H: int) -> int:
    """Ring tiles a warpgroup of the streamed design at (F, H): as many
    pairs of 16 KB tiles as fit (at most WG_MAX_STAGES) beside one x
    buffer, one h buffer, the barriers and 1,024 bytes of alignment; 0
    where H > 256 or fewer than two fit."""
    if H > WG_MAX_H:
        return 0
    room = max(0, _MAX_SMEM - _wgmma_fixed_smem(F, H, 1))
    stages = min(WG_MAX_STAGES, room // (2 * WG_TILE_BYTES))
    return stages if stages >= 2 else 0


def wgmma_plan(F: int, H: int, B: int) -> tuple[int, int, int] | None:
    """(kind, stages, x buffers) of the wgmma kernel at (F, H) (any B: a
    grid of 2 * ceil(B / 64) blocks of 64 rows, one an SM, no clusters),
    None where it does not fit. (WG_RESIDENT, 0, 0) where the weights
    stay in shared memory: F <= 32 and H <= 128 (the branches, 160 KB at
    H = 128). Else (WG_STREAMED, wgmma_stages, x buffers) where two
    stages fit: x_{t+1} is staged into a second x buffer during step t
    where one fits beside the rings."""
    if F <= RS_MAX_F and H <= RS_MAX_H and resident_smem(H) <= _MAX_SMEM:
        return WG_RESIDENT, 0, 0
    stages = wgmma_stages(F, H)
    if not stages:
        return None
    x_buffers = 2 if _wgmma_fixed_smem(F, H, 2) + \
        stages * 2 * WG_TILE_BYTES <= _MAX_SMEM else 1
    return WG_STREAMED, stages, x_buffers


_mma_only = False


@contextlib.contextmanager
def mma_only():
    """While this holds, every bfloat16 layer takes the mma.sync kernel
    (k1_bf16_plan gives None): for timing the two kernels in turns on
    the same path."""
    global _mma_only
    before, _mma_only = _mma_only, True
    try:
        yield
    finally:
        _mma_only = before


def k1_bf16_plan(F: int, H: int, B: int) -> tuple[int, int, int] | None:
    """The bfloat16 K1 kernel a layer takes: wgmma_plan's (kind, stages, x
    buffers) of the wgmma kernel (``fused_bilstm_bf16_wgmma``), which
    takes every shape it fits, or None for the mma.sync kernel
    (``fused_bilstm_bf16``): where it does not fit, and everywhere inside
    ``mma_only()``."""
    return None if _mma_only else wgmma_plan(F, H, B)


def weight_l2_bytes(kind: str, T: int, F: int, H: int, B: int) -> int:
    """Bytes of packed weights a bfloat16 layer of T steps and B rows
    reads from L2 by the design of kernel ``kind`` (not measured): "mma",
    every 32-row block its direction's (4H x padded_k(F, H)) matrix at
    every step; "wgmma", every 64-row block its direction's packed
    matrix, once a launch where it is resident (4 Hp x (RS_KX + Hp)), else
    once a step (4 Hp x (Kx + Hp), Kx = 64 ceil(F / 64)); Hp = 64 ceil(H /
    64)."""
    if kind == "mma":
        return 2 * -(-B // 32) * T * 4 * H * padded_k(F, H) * 2
    nkx, nch = wgmma_dims(F, H)
    blocks = 2 * -(-B // WG_ROWS)
    if wgmma_plan(F, H, B)[0] == WG_RESIDENT:
        return blocks * 4 * 64 * nch * (RS_KX + 64 * nch) * 2
    return blocks * T * 4 * 64 * nch * 64 * (nkx + nch) * 2


def _wgmma_columns(w_ih, w_hh, Kx: int) -> torch.Tensor:
    """[W_ih; W_hh] as (2, Kx + Hp, 2, nch, 128) float32 (rows: W_ih's
    zero-padded to Kx, then W_hh's padded to Hp = 64 nch; columns by
    warpgroup w, chunk cc and packed column n = 32 ug + 8 gate + e, which
    holds gate ``gate`` of unit 32 (w nch + cc) + 8 ug + e, zero for units
    >= H)."""
    F, H = w_ih.shape[1], w_hh.shape[1]
    nch = -(-H // 64)
    Hp = 64 * nch
    w = w_ih.new_zeros((2, Kx + Hp, 4, Hp), dtype=torch.float32)
    w[:, :F, :, :H] = w_ih.float().reshape(2, F, 4, H)
    w[:, Kx:Kx + H, :, :H] = w_hh.float().reshape(2, H, 4, H)
    # units as (warpgroup, chunk, ug, e); columns as (w, cc, ug, gate, e)
    w = w.reshape(2, Kx + Hp, 4, 2, nch, 4, 8).permute(0, 1, 3, 4, 5, 2, 6)
    return w.reshape(2, Kx + Hp, 2, nch, 128)


def _swizzle(t: torch.Tensor, chunks: int) -> torch.Tensor:
    """Tiles (..., 128, 8 * chunks) as the K-major images wgmma reads in
    the swizzle of 16 * chunks-byte rows: the 16-byte chunk c of row n at
    chunk c ^ (n % 8) (128-byte rows, 8 chunks) or c ^ ((n // 2) % 4)
    (64-byte rows, 4 chunks). The map is its own inverse, so chunk c of
    the image is the tile's chunk c ^ ...: a gather."""
    n = torch.arange(128).view(128, 1)
    pos = torch.arange(chunks).view(1, chunks) ^ (
        n % 8 if chunks == 8 else (n // 2) % 4)
    t = t.reshape(*t.shape[:-1], chunks, 8)
    idx = pos.view(128, chunks, 1).expand(128, chunks, 8)
    out = torch.gather(t, -2, idx.expand(t.shape).to(t.device))
    return out.reshape(*t.shape[:-2], 8 * chunks)


@torch.no_grad()
def pack_weights_wgmma(w_ih: torch.Tensor, w_hh: torch.Tensor
                       ) -> torch.Tensor:
    """The streamed design's weights, in the order it streams them: (2,
    nch * nkb, 2, 128, 64) bf16, per direction, chunk cc and K slab in
    stream order (the nch h slabs, then the nkx x slabs; wgmma_dims), the
    two warpgroups' 128 x 64 tiles (16 KB each, one copy), each the
    128-byte swizzled image of (packed column n, k): element (n, k) at
    [n, 8 * ((k // 8) ^ (n % 8)) + k % 8]. Slab kb of x holds W_ih rows
    [64 kb, 64 kb + 64), of h W_hh's, zero past F and H. Warpgroup w's
    packed column 32 * ug + 8 * gate + e of chunk cc is gate ``gate`` (i,
    f, g, o) of unit u = 32 * (w * nch + cc) + 8 * ug + e, zero for u >=
    H. w_ih (2, F, 4H), w_hh (2, H, 4H), any float dtype. A layout
    transform in plain tensor ops."""
    F, H = w_ih.shape[1], w_hh.shape[1]
    nkx, nch = wgmma_dims(F, H)
    w = _wgmma_columns(w_ih, w_hh, nkx * WG_K)
    w = w.reshape(2, nkx + nch, WG_K, 2, nch, 128)
    order = list(range(nkx, nkx + nch)) + list(range(nkx))
    w = w[:, order]                        # K slabs in stream order
    # (d, cc, kb, w, n, k): one stage is (2, 128, 64)
    w = _swizzle(w.permute(0, 4, 1, 3, 5, 2), 8)
    return w.reshape(2, nch * (nkx + nch), 2, 128, 64).to(
        torch.bfloat16).contiguous()


@torch.no_grad()
def pack_weights_resident(w_ih: torch.Tensor, w_hh: torch.Tensor
                          ) -> torch.Tensor:
    """The resident design's weights, as each block copies them into its
    shared memory: (2, 2, nch, RS_KX * 128 + nch * 64 * 128) bf16 (nch =
    ceil(H / 64), F <= RS_KX): per direction, warpgroup w and chunk cc,
    W_ih's 128 x RS_KX tile (rows [0, F), zero to RS_KX) in the 64-byte
    swizzle, element (n, k) at [n, 8 * ((k // 8) ^ ((n // 2) % 4)) + k %
    8], then W_hh's nch 128 x 64 tiles (rows [64 kb, 64 kb + 64), zero past
    H) in the 128-byte swizzle, as pack_weights_wgmma's; packed columns
    as there. w_ih (2, F, 4H), w_hh (2, H, 4H), any float dtype. A layout
    transform in plain tensor ops."""
    F, H = w_ih.shape[1], w_hh.shape[1]
    if F > RS_KX:
        raise ValueError(f"the resident design takes F <= {RS_KX} (got {F})")
    nch = -(-H // 64)
    w = _wgmma_columns(w_ih, w_hh, RS_KX)       # (d, K, w, cc, n)
    x = _swizzle(w[:, :RS_KX].permute(0, 2, 3, 4, 1), 4)   # (d, w, cc, n, k)
    h = w[:, RS_KX:].reshape(2, nch, WG_K, 2, nch, 128)
    h = _swizzle(h.permute(0, 3, 4, 1, 5, 2), 8)   # (d, w, cc, kb, n, k)
    return torch.cat([x.reshape(2, 2, nch, -1), h.reshape(2, 2, nch, -1)],
                     -1).to(torch.bfloat16).contiguous()


_PACKERS = {"wgmma": pack_weights_wgmma, "resident": pack_weights_resident,
            "mma": pack_weights}


def packed_weights(layer, kind: str) -> torch.Tensor:
    """The packed weights of a layer module (w_ih, w_hh parameters) for
    packing ``kind`` (packed_for's: "wgmma", "resident" or "mma"), packed
    once and cached on the module until a parameter changes: the cache
    key holds both parameters' version counters (moved by every in-place
    update, such as an optimizer step) and data pointers."""
    key = (layer.w_ih._version, layer.w_ih.data_ptr(), layer.w_hh._version,
           layer.w_hh.data_ptr())
    cache = layer.__dict__.setdefault("_k1_packed", {})
    cached = cache.get(kind)
    if cached is None or cached[0] != key:
        cached = (key, _PACKERS[kind](layer.w_ih, layer.w_hh))
        cache[kind] = cached
    return cached[1]


def proj_k(F: int) -> int:
    """K columns of one row-split input in the projection's packed
    weights: F rounded up to the kernel's K slab of 32."""
    return -(-F // 32) * 32


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 w, each a tf32 value (low 13 bits zero), with
    w = hi + lo up to lo's rounding (2^-22 of w): the integer split of
    csrc/dsp_common.cuh::split_tf32 (round to nearest, ties away from
    zero), in tensor ops. The kernels leave lo's low bits in place, which
    the tensor cores ignore; here they are cleared."""
    bits = w.contiguous().view(torch.int32)
    mask = -8192                           # 0xffffe000
    hi = ((bits + 0x1000) & mask).view(torch.float32)
    lo = (((w - hi).view(torch.int32) + 0x1000) & mask).view(torch.float32)
    return hi, lo


@torch.no_grad()
def pack_proj_weights(w_ih: torch.Tensor, Fa: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 projection kernel's weights for inputs split at Fa
    (Fb = F - Fa): the tf32 (hi, lo) planes, each (2, 4H, Kp) float32,
    K-major: plane[d, n, k] = w_ih[d, k, n] for k < Fa, w_ih[d, Fa + k -
    Kpa, n] for Kpa <= k < Kpa + Fb, zero elsewhere, Kpa = proj_k(Fa),
    Kp = Kpa + proj_k(Fb). A layout transform and the tf32 split in plain
    tensor ops."""
    F = w_ih.shape[1]
    Fb = F - Fa
    Kpa = proj_k(Fa)
    w = w_ih.to(torch.float32).transpose(1, 2)            # (2, 4H, F)
    wt = w.new_zeros((2, w.shape[1], Kpa + proj_k(Fb)))
    wt[:, :, :Fa] = w[:, :, :Fa]
    wt[:, :, Kpa:Kpa + Fb] = w[:, :, Fa:]
    return tf32_split(wt)


def packed_proj_weights(layer, Fa: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``pack_proj_weights`` of a layer module's w_ih for inputs split at
    Fa, packed once and cached on the module until w_ih changes (the
    cache key holds its version counter, data pointer and Fa)."""
    key = (layer.w_ih._version, layer.w_ih.data_ptr(), Fa)
    cached = layer.__dict__.get("_k1_proj_packed")
    if cached is None or cached[0] != key:
        cached = (key, pack_proj_weights(layer.w_ih, Fa))
        layer.__dict__["_k1_proj_packed"] = cached
    return cached[1]


# K1's float32 wgmma recurrence (csrc/lstm_recurrence.cu, k1_rec): ring
# stages of 16 K rows of W_hh[d] for both consumer warpgroups' 128 packed
# columns, as tf32 hi and lo tiles (32 KB)
REC_KS, REC_TILE_N = 16, 128


@torch.no_grad()
def pack_rec_weights(w_hh: torch.Tensor) -> torch.Tensor:
    """K1's float32 wgmma recurrence's weights, in the order it streams
    them: (2, nch * H / 16, 2, 2, 128, 16) float32, nch = H / 64 (H 128
    or 256): per direction, per chunk cc and 16-row K slab kb (stage cc *
    H / 16 + kb), per consumer warpgroup w, the tf32 (hi, lo) planes of
    W_hh (tf32_split), each a 128 x 16 tile K-major in the 64-byte
    swizzled image wgmma reads: element (n, k) at [n, 4 * ((k // 4) ^ ((n
    // 2) % 4)) + k % 4]. Packed column n = 32 * ug + 8 * gate + e of
    warpgroup w's chunk cc is gate ``gate`` (i, f, g, o) of unit u = 32 *
    (w * nch + cc) + 8 * ug + e, and k of slab kb W_hh's row 16 * kb + k:
    tile[n, k] = w_hh[d, 16 kb + k, gate * H + u]. A layout transform and
    the tf32 split in plain tensor ops."""
    H = w_hh.shape[1]
    nch, nks = H // 64, H // REC_KS
    w = w_hh.to(torch.float32).reshape(2, H, 4, 2, nch, 4, 8)
    # (d, k, gate, w, cc, ug, e) -> (d, cc, kb, w, n = (ug, gate, e), k)
    w = w.permute(0, 4, 3, 5, 2, 6, 1).reshape(2, nch, 2, REC_TILE_N, nks,
                                               REC_KS)
    w = w.permute(0, 1, 4, 2, 3, 5)
    hi, lo = tf32_split(w.contiguous())
    t = torch.stack([hi, lo], 4).reshape(2, nch, nks, 2, 2, REC_TILE_N, 4, 4)
    n = torch.arange(REC_TILE_N).view(REC_TILE_N, 1)
    idx = torch.arange(4).view(1, 4) ^ ((n >> 1) & 3)      # [n, chunk]
    idx = idx.view(REC_TILE_N, 4, 1).expand(REC_TILE_N, 4, 4)
    t = torch.gather(t, 6, idx.expand(t.shape).to(t.device))
    return t.reshape(2, nch * nks, 2, 2, REC_TILE_N, REC_KS).contiguous()


def packed_rec_weights(layer) -> torch.Tensor:
    """``pack_rec_weights`` of a layer module's w_hh, packed once and
    cached on the module until w_hh changes (the cache key holds its
    version counter and data pointer)."""
    key = (layer.w_hh._version, layer.w_hh.data_ptr())
    cached = layer.__dict__.get("_k1_rec_packed")
    if cached is None or cached[0] != key:
        cached = (key, pack_rec_weights(layer.w_hh))
        layer.__dict__["_k1_rec_packed"] = cached
    return cached[1]


def inloop_rows(H: int) -> int:
    """Batch rows of a block of the in-loop float32 kernel
    (csrc/fused_bilstm.cu::launch_f32: 16 rows a thread, 256 // round_up(H,
    32) thread rows a block, at least one)."""
    width = -(-H // 32) * 32
    return 16 * max(1, 256 // width)


# the narrow kernel (csrc/fused_bilstm.cu: fused_bilstm_narrow_f32_kernel):
# inputs of at most 16 features (x columns padded to 8 or 16); a block of
# 16 warps owns NARROW_UNITS[H] hidden units (a cluster H / that blocks);
# row tiles of 16 to 128 rows
NARROW_UNITS = {128: 64, 256: 32}
NARROW_ROWS = tuple(range(16, 129, 16))
NARROW_MAX_F = 16
# the fewest rows at which f32_route takes the narrow kernel
NARROW_MIN_ROWS = 256


def narrow_kx(F: int) -> int:
    """x columns of the narrow kernel (and of its packed weights): F
    rounded up to 8 or 16 (8 for the seq branch's 7, 16 for the signal
    branch's 16)."""
    return 8 if F <= 8 else 16


def narrow_smem(F: int, H: int, rows: int) -> int:
    """Shared-memory bytes of a block of the narrow kernel
    (csrc/fused_bilstm.cu's narrow_smem): its weight slice transposed, 4U
    rows (U = NARROW_UNITS[H]), and the A buffer [x_t | h_{t-1}], ``rows``
    rows, each row Kx + H + 4 floats (the 4 make the ldmatrix reads
    conflict-free)."""
    K = narrow_kx(F) + H
    return 4 * (K + 4) * (4 * NARROW_UNITS[H] + rows)


def narrow_plan(F: int, H: int, B: int, capacity):
    """(cluster, rows) of the narrow kernel for a float32 layer of input
    width F, hidden size H and B rows, or None where it has no plan.
    ``capacity(cluster, rows)`` is how many clusters of that plan the card
    holds at once (the wrapper asks the card, narrow_capacity). The grid
    is 2 * ceil(B / rows) clusters of H / U blocks.

    The shape rule: F <= 16 (the kernel is built for x columns of 8 and
    16: the seq and signal branches' 7 and 16 features) and H = 128
    (clusters of 2 blocks of 64 units) or 256 (clusters of 8 of 32): a
    block's slice of [W_ih; W_hh] has to fit its shared memory beside the
    A buffer, and a cluster has at most 8 blocks.

    Among the row tiles whose shared memory fits, with waves = 2 *
    ceil(B / rows) / capacity rounded up, the least estimated time waves x
    (rows / 16 + 1.5): a wave's step grows by about one m16 tile's
    products per 16 rows of its tile, beside a fixed part worth about 1.5
    of them (the cell update, the two cluster barriers), as timed on the
    H100 at 16 to 128 rows (PERF.md); ties take fewer waves, then the
    smaller tile. On the H100: 128-row tiles at 4,096 rows (64 clusters of
    2, one wave), 32 at 1,016, 16 at 512; at H = 256, 80 at 512 (14
    clusters of 8)."""
    U = NARROW_UNITS.get(H)
    if U is None or not 1 <= F <= NARROW_MAX_F:
        return None
    C = H // U
    best = None
    for rows in NARROW_ROWS:
        if narrow_smem(F, H, rows) > _MAX_SMEM:
            continue
        cap = capacity(C, rows)
        if cap < 1:
            continue
        waves = -(-2 * -(-B // rows) // cap)
        cost = (waves * (rows // 16 + 1.5), waves, rows)
        if best is None or cost < best[0]:
            best = cost, rows
    return None if best is None else (C, best[1])


@functools.cache
def narrow_capacity(device: int, F: int, H: int, cluster: int,
                    rows: int) -> int:
    """Clusters of a narrow-kernel plan that card ``device`` holds at once
    (the kernel's occupancy query), cached per device and plan."""
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.dsp_fused_bilstm_narrow_clusters(narrow_kx(F), H, cluster,
                                                   rows, ctypes.byref(n))
    _build.check(lib, err, "narrow kernel occupancy query")
    return n.value


def narrow_plan_on(device: torch.device, F: int, H: int, B: int):
    """narrow_plan on the capacity of card ``device``."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    return narrow_plan(F, H, B, lambda C, rows: narrow_capacity(
        idx, narrow_kx(F), H, C, rows))


def f32_route(F: int, H: int, B: int, sms: int, narrow) -> str:
    """The route of a float32 layer of input width F, hidden size H and B
    rows on a card of ``sms`` SMs, where ``narrow`` is its narrow_plan
    (None where it has none): "narrow", the narrow kernel, wherever it has
    a plan at B >= NARROW_MIN_ROWS; else "inloop", the in-loop kernel
    (CUDA-core FMAs), where the input is narrower than the projection's
    K slab (F < 32: xproj would be 4H / F times the input's bytes) and its
    grid, 2 * ceil(B / inloop_rows(H)) blocks, fills the card; else
    "split", the projection kernel and the recurrence (the comb layers,
    and the narrow layers below NARROW_MIN_ROWS rows). On the H100
    (chip_smoke.py phase 3, PERF.md) the narrow kernel was the fastest of
    the three routes at every shape timed from 256 rows up (the
    branches at 4,096, 1,016, 512 and 256 rows; H = 256 at 512 and 256)
    and slower than the split route at denoise's 93-row tail (H = 256);
    the in-loop kernel was the faster of the other two at 4,096 rows and
    the slower at 1,016."""
    if narrow is not None and B >= NARROW_MIN_ROWS:
        return "narrow"
    if F < 32 and 2 * -(-B // inloop_rows(H)) >= sms:
        return "inloop"
    return "split"


def f32_route_on(device: torch.device, F: int, H: int, B: int):
    """(route, narrow plan) of a float32 layer on card ``device``
    (f32_route on its SM count and narrow_plan_on)."""
    narrow = narrow_plan_on(device, F, H, B)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return f32_route(F, H, B, sms, narrow), narrow


@torch.no_grad()
def pack_narrow_weights(w_ih: torch.Tensor, w_hh: torch.Tensor
                        ) -> torch.Tensor:
    """The narrow kernel's weights: (2, 4H, Kx + H) float32, K-major, Kx =
    narrow_kx(F): row 32 grp + 8 gate + e holds gate ``gate`` (i, f, g, o)
    of unit 8 grp + e, so block r of a cluster copies the contiguous rows
    [4U r, 4U (r + 1)) (its U units, as its warps' four gate tiles of an
    8-unit group side by side); column k < F is W_ih's row k, columns [F,
    Kx) are zero, column Kx + k is W_hh's row k. w_ih (2, F, 4H), w_hh
    (2, H, 4H), H a multiple of 8. A layout transform in plain tensor
    ops."""
    F, H = w_ih.shape[1], w_hh.shape[1]
    Kx = narrow_kx(F)
    K = Kx + H
    w = w_ih.new_zeros((2, K, 4, H), dtype=torch.float32)
    w[:, :F] = w_ih.float().reshape(2, F, 4, H)
    w[:, Kx:] = w_hh.float().reshape(2, H, 4, H)
    # rows (group, gate, unit in the group), K-major
    return w.reshape(2, K, 4, H // 8, 8).permute(0, 3, 2, 4, 1).reshape(
        2, 4 * H, K).contiguous()


def packed_narrow_weights(layer) -> torch.Tensor:
    """``pack_narrow_weights`` of a layer module's w_ih and w_hh, packed
    once and cached on the module until either changes (the cache key
    holds both parameters' version counters and data pointers)."""
    key = (layer.w_ih._version, layer.w_ih.data_ptr(), layer.w_hh._version,
           layer.w_hh.data_ptr())
    cached = layer.__dict__.get("_k1_narrow_packed")
    if cached is None or cached[0] != key:
        cached = (key, pack_narrow_weights(layer.w_ih, layer.w_hh))
        layer.__dict__["_k1_narrow_packed"] = cached
    return cached[1]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_bilstm")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dsp_fused_bilstm_f32.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.dsp_fused_bilstm_bf16.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.dsp_fused_bilstm_proj_f32.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.dsp_fused_bilstm_bf16_wgmma.argtypes = [P] * 6 + [I] * 9 + [P]
    lib.dsp_fused_bilstm_f32_narrow.argtypes = [P] * 6 + [I] * 8 + [P]
    lib.dsp_fused_bilstm_narrow_clusters.argtypes = [I] * 4 + [
        ctypes.POINTER(I)]
    for fn in (lib.dsp_fused_bilstm_f32, lib.dsp_fused_bilstm_bf16,
               lib.dsp_fused_bilstm_proj_f32, lib.dsp_fused_bilstm_bf16_wgmma,
               lib.dsp_fused_bilstm_f32_narrow,
               lib.dsp_fused_bilstm_narrow_clusters):
        fn.restype = ctypes.c_int
    return lib


def input_projection(xs, w_ih: torch.Tensor, b: torch.Tensor,
                     packed: tuple[torch.Tensor, torch.Tensor] | None = None
                     ) -> torch.Tensor:
    """The float32 route's projection: xs 1 or 2 row-split (T, B, F_i)
    float32 -> xproj (T, 2, B, 4H) float32, K2's contract (bias in,
    direction 1 time-flipped; ops/lstm.py::input_projection). On the card
    one launch of the 3xTF32 projection kernel over ``packed`` (made here
    when not given); xproj is a new tensor of T*2*4H*4 bytes a row (104 KB
    at H=256: 436 MB at a 4096-row tile), which the caching allocator
    keeps for the next call."""
    xs = tuple(xs)
    if xs[0].device.type == "cpu":
        return plain.input_projection(xs, w_ih, b)
    T, B, Fa = xs[0].shape
    Fb = xs[1].shape[-1] if len(xs) == 2 else 0
    G4 = b.shape[-1]
    if packed is None:
        packed = pack_proj_weights(w_ih, Fa)
    w_hi, w_lo = packed
    Kp = proj_k(Fa) + proj_k(Fb)
    for name, t in (("w_hi", w_hi), ("w_lo", w_lo)):
        if tuple(t.shape) != (2, G4, Kp) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != xs[0].device:
            raise ValueError(f"{name} must be contiguous (2, {G4}, {Kp}) "
                             f"float32 on {xs[0].device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    xproj = torch.empty((T, 2, B, G4), dtype=torch.float32,
                        device=xs[0].device)
    lib = _lib()
    with torch.cuda.device(xs[0].device):
        err = lib.dsp_fused_bilstm_proj_f32(
            xs[0].data_ptr(), xs[1].data_ptr() if Fb else None,
            w_hi.data_ptr(), w_lo.data_ptr(), b.data_ptr(), xproj.data_ptr(),
            T, B, Fa, Fb, G4 // 4, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fused_bilstm_proj_f32 launch")
    launches["fused_bilstm_proj_f32"] += 1
    return xproj


def _check_packed(packed: torch.Tensor, shape: tuple, dev) -> None:
    if tuple(packed.shape) != shape or packed.dtype != torch.bfloat16 or \
            not packed.is_contiguous() or packed.device != dev or \
            packed.data_ptr() % 16:
        raise ValueError(f"packed must be contiguous 16-byte aligned {shape} "
                         f"bfloat16 on {dev}; got {tuple(packed.shape)} "
                         f"{packed.dtype} on {packed.device}")


def _check_inputs(xs, w_ih, b, w_hh, H) -> None:
    dev, dtype = xs[0].device, xs[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"fused_bilstm takes float32 or bfloat16 (got {dtype})")
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"fused_bilstm takes 1 or 2 inputs (got {len(xs)})")
    if not 1 <= H <= _MAX_HIDDEN:
        raise ValueError(f"fused_bilstm takes 1 <= H <= {_MAX_HIDDEN} "
                         f"(got {H})")
    T, B = xs[0].shape[:2]
    for x in xs:
        if x.dim() != 3 or tuple(x.shape[:2]) != (T, B):
            raise ValueError(f"inputs must share (T, B) = {(T, B)}; got "
                             f"{tuple(x.shape)}")
    F = sum(x.shape[-1] for x in xs)
    # float32 reads w_hh as it is and w_ih through its packed planes;
    # bfloat16 reads only the packed copy of both, so they may be of any
    # float dtype there
    wdt = dtype if dtype == torch.float32 else None
    want = {"w_ih": ((2, F, 4 * H), wdt), "w_hh": ((2, H, 4 * H), wdt),
            "b": ((2, 4 * H), torch.float32)}
    named = list(zip(("x", "x2"), xs)) + [
        ("w_ih", w_ih), ("w_hh", w_hh), ("b", b)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, inputs on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want:
            shape, dt = want[name]
            if tuple(t.shape) != shape or (dt is not None and t.dtype != dt):
                raise ValueError(f"{name} must be {shape} {dt or ''}; got "
                                 f"{tuple(t.shape)} {t.dtype}")
        elif t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {dtype}")


def _layer_inputs(xs, w_ih, b, w_hh, H):
    """xs as a tuple, checked on the card (_check_inputs); None for CPU
    tensors, which take the plain version."""
    if not isinstance(xs, (tuple, list)):
        xs = (xs,)
    xs = tuple(xs)
    if xs[0].device.type == "cpu":
        return None
    if xs[0].device.type != "cuda":
        raise ValueError(f"fused_bilstm runs on cuda or cpu tensors "
                         f"(got {xs[0].device})")
    _check_inputs(xs, w_ih, b, w_hh, H)
    return xs


def layer_f32_split(xs, w_ih: torch.Tensor, b: torch.Tensor,
                    w_hh: torch.Tensor, hidden_size: int,
                    seq_out: bool = True, packed=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 layer through the split route: input_projection, then
    lstm_recurrence_k1, over ``packed`` = (pack_proj_weights at this row
    split, pack_rec_weights or None), either made where needed when None.
    Arguments and result as bilstm_layer_fused's; a CPU tensor takes the
    plain version."""
    H = hidden_size
    checked = _layer_inputs(xs, w_ih, b, w_hh, H)
    if checked is None:
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    if checked[0].dtype != torch.float32:
        raise TypeError("the split route takes float32")
    return _split(checked, w_ih, b, w_hh, H, seq_out, packed)


def _split(xs, w_ih, b, w_hh, H, seq_out, packed):
    proj, rec = packed or (None, None)
    return _rec.lstm_recurrence_k1(input_projection(xs, w_ih, b, proj),
                                   w_hh, H, seq_out, launches, rec)


def layer_f32_inloop(xs, w_ih: torch.Tensor, b: torch.Tensor,
                     w_hh: torch.Tensor, hidden_size: int,
                     seq_out: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 layer through the in-loop kernel (one launch, CUDA-core
    FMAs, the input projection inside the time loop). Arguments and
    result as bilstm_layer_fused's; a CPU tensor takes the plain
    version."""
    H = hidden_size
    checked = _layer_inputs(xs, w_ih, b, w_hh, H)
    if checked is None:
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    if checked[0].dtype != torch.float32:
        raise TypeError("the in-loop kernel takes float32")
    return _launch(checked, w_ih, b, w_hh, H, seq_out, None)


def layer_f32_narrow(xs, w_ih: torch.Tensor, b: torch.Tensor,
                     w_hh: torch.Tensor, hidden_size: int,
                     seq_out: bool = True, packed=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 layer through the narrow kernel (one launch, 3xTF32 over
    ``packed``, its pack_narrow_weights, made here when not given) on
    narrow_plan's clusters and row tiles. Raises where the kernel has no
    plan (F >= 32, H other than 128 and 256). Arguments and result as
    bilstm_layer_fused's; a CPU tensor takes the plain version."""
    H = hidden_size
    checked = _layer_inputs(xs, w_ih, b, w_hh, H)
    if checked is None:
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    if checked[0].dtype != torch.float32:
        raise TypeError("the narrow kernel takes float32")
    B = checked[0].shape[1]
    F = sum(x.shape[-1] for x in checked)
    plan = narrow_plan_on(checked[0].device, F, H, B)
    if plan is None:
        raise ValueError(f"the narrow kernel has no plan for F={F} H={H}")
    return _launch_narrow(checked, w_ih, b, w_hh, H, seq_out, packed, plan)


def _launch_narrow(xs, w_ih, b, w_hh, H, seq_out, packed, plan):
    """One launch of the narrow kernel on checked float32 inputs, on
    ``plan``'s (cluster, rows)."""
    T, B, Fa = xs[0].shape
    Fb = xs[1].shape[-1] if len(xs) == 2 else 0
    if packed is None:
        packed = pack_narrow_weights(w_ih, w_hh)
    shape = (2, 4 * H, narrow_kx(Fa + Fb) + H)
    if tuple(packed.shape) != shape or packed.dtype != torch.float32 or \
            not packed.is_contiguous() or packed.device != xs[0].device \
            or packed.data_ptr() % 16:
        raise ValueError(f"packed must be contiguous 16-byte aligned {shape} "
                         f"float32 on {xs[0].device}; got "
                         f"{tuple(packed.shape)} {packed.dtype} on "
                         f"{packed.device}")
    out_T = T if seq_out else 1
    ys_f = torch.empty((out_T, B, H), dtype=torch.float32,
                       device=xs[0].device)
    ys_b = torch.empty_like(ys_f)
    lib = _lib()
    with torch.cuda.device(xs[0].device):
        err = lib.dsp_fused_bilstm_f32_narrow(
            xs[0].data_ptr(), xs[1].data_ptr() if Fb else None,
            packed.data_ptr(), b.data_ptr(), ys_f.data_ptr(),
            ys_b.data_ptr(), T, B, Fa, Fb, H, int(seq_out), *plan,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fused_bilstm_f32_narrow launch")
    launches["fused_bilstm_f32_narrow"] += 1
    return ys_f, ys_b


def layer_bf16_wgmma(xs, w_ih: torch.Tensor, b: torch.Tensor,
                     w_hh: torch.Tensor, hidden_size: int,
                     seq_out: bool = True, packed=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """A bfloat16 layer through the wgmma kernel on wgmma_plan's design
    (over ``packed``, the weights packed for it: pack_weights_resident or
    pack_weights_wgmma, made here when not given). Raises where the
    kernel does not fit (H > 256, or fewer than two ring stages).
    Arguments and result as bilstm_layer_fused's; a CPU tensor takes the
    plain version."""
    H = hidden_size
    checked = _layer_inputs(xs, w_ih, b, w_hh, H)
    if checked is None:
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    if checked[0].dtype != torch.bfloat16:
        raise TypeError("the wgmma kernel takes bfloat16")
    T, B, _ = checked[0].shape
    F = sum(x.shape[-1] for x in checked)
    plan = wgmma_plan(F, H, B)
    if plan is None:
        raise ValueError(f"the wgmma kernel does not fit F={F} H={H}")
    return _launch_wgmma(checked, w_ih, b, w_hh, H, seq_out, packed, plan)


def layer_bf16_mma(xs, w_ih: torch.Tensor, b: torch.Tensor,
                   w_hh: torch.Tensor, hidden_size: int,
                   seq_out: bool = True, packed=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """A bfloat16 layer through the mma.sync kernel (over ``packed``, its
    pack_weights, made here when not given). Arguments and result as
    bilstm_layer_fused's; a CPU tensor takes the plain version."""
    H = hidden_size
    checked = _layer_inputs(xs, w_ih, b, w_hh, H)
    if checked is None:
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    if checked[0].dtype != torch.bfloat16:
        raise TypeError("the mma.sync kernel takes bfloat16")
    return _launch(checked, w_ih, b, w_hh, H, seq_out, packed)


def _launch_wgmma(xs, w_ih, b, w_hh, H, seq_out, packed, plan):
    """One launch of the wgmma kernel on checked bfloat16 inputs, on
    ``plan``'s (kind, stages, x buffers)."""
    T, B, Fa = xs[0].shape
    Fb = xs[1].shape[-1] if len(xs) == 2 else 0
    nkx, nch = wgmma_dims(Fa + Fb, H)
    if plan[0] == WG_RESIDENT:
        if packed is None:
            packed = pack_weights_resident(w_ih, w_hh)
        shape = (2, 2, nch, (RS_XTILE_BYTES + nch * WG_TILE_BYTES) // 2)
    else:
        if packed is None:
            packed = pack_weights_wgmma(w_ih, w_hh)
        shape = (2, nch * (nkx + nch), 2, 128, WG_K)
    _check_packed(packed, shape, xs[0].device)
    out_T = T if seq_out else 1
    ys_f = torch.empty((out_T, B, H), dtype=xs[0].dtype, device=xs[0].device)
    ys_b = torch.empty_like(ys_f)
    lib = _lib()
    with torch.cuda.device(xs[0].device):
        err = lib.dsp_fused_bilstm_bf16_wgmma(
            xs[0].data_ptr(), xs[1].data_ptr() if Fb else None,
            packed.data_ptr(), b.data_ptr(), ys_f.data_ptr(),
            ys_b.data_ptr(), T, B, Fa, Fb, H, int(seq_out), *plan,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fused_bilstm_bf16_wgmma launch")
    launches["fused_bilstm_bf16_wgmma"] += 1
    return ys_f, ys_b


def _launch(xs, w_ih, b, w_hh, H, seq_out, packed):
    """One launch of the bfloat16 mma.sync kernel (over ``packed``, made
    here when not given) or of the float32 in-loop kernel, on checked
    inputs."""
    T, B, Fa = xs[0].shape
    Fb = xs[1].shape[-1] if len(xs) == 2 else 0
    bf16 = xs[0].dtype == torch.bfloat16
    name = "fused_bilstm_bf16" if bf16 else "fused_bilstm_f32_inloop"
    out_T = T if seq_out else 1
    ys_f = torch.empty((out_T, B, H), dtype=xs[0].dtype, device=xs[0].device)
    ys_b = torch.empty_like(ys_f)
    lib = _lib()
    x1 = xs[1].data_ptr() if Fb else None
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            if packed is None:
                packed = pack_weights(w_ih, w_hh)
            _check_packed(packed, (2, 4 * H, padded_k(Fa + Fb, H)),
                          xs[0].device)
            err = lib.dsp_fused_bilstm_bf16(
                xs[0].data_ptr(), x1, packed.data_ptr(), b.data_ptr(),
                ys_f.data_ptr(), ys_b.data_ptr(), T, B, Fa, Fb, H,
                int(seq_out), stream)
        else:
            err = lib.dsp_fused_bilstm_f32(
                xs[0].data_ptr(), x1, w_ih.data_ptr(), b.data_ptr(),
                w_hh.data_ptr(), ys_f.data_ptr(), ys_b.data_ptr(), T, B, Fa,
                Fb, H, int(seq_out), stream)
    _build.check(lib, err, name + " launch")
    launches[name] += 1
    return ys_f, ys_b


def bilstm_layer_fused(xs, w_ih: torch.Tensor, b: torch.Tensor,
                       w_hh: torch.Tensor, hidden_size: int,
                       seq_out: bool = True, packed=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused BiLSTM layer, time-major. ``xs``: a (T, B, F) tensor or a
    tuple of two (their F's concatenate against w_ih's rows), in float32
    or bfloat16; w_ih (2, F, 4H) and w_hh (2, H, 4H) in that dtype (for
    bfloat16, any float dtype: the kernel k1_bf16_plan picks reads
    ``packed``, the weights packed for it (``packed_for``), made here
    when not given; float32's narrow and split routes read ``packed``,
    the weights packed for the route f32_route gives the layer
    (``f32_packed``: pack_narrow_weights, or (pack_proj_weights at this
    row split, pack_rec_weights or None)), made where needed when not
    given); b (2, 4H) float32. Returns
    (ys_f, ys_b), each (T, B, H) in true time, or (1, B, H) final states
    when ``seq_out`` is False."""
    H = hidden_size
    checked = _layer_inputs(xs, w_ih, b, w_hh, H)
    if checked is None:
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    T, B, _ = checked[0].shape
    F = sum(x.shape[-1] for x in checked)
    if checked[0].dtype == torch.bfloat16:
        plan = k1_bf16_plan(F, H, B)
        if plan is None:
            return _launch(checked, w_ih, b, w_hh, H, seq_out, packed)
        return _launch_wgmma(checked, w_ih, b, w_hh, H, seq_out, packed,
                             plan)
    route, narrow = f32_route_on(checked[0].device, F, H, B)
    if route == "narrow":
        return _launch_narrow(checked, w_ih, b, w_hh, H, seq_out, packed,
                              narrow)
    if route == "inloop":
        return _launch(checked, w_ih, b, w_hh, H, seq_out, None)
    return _split(checked, w_ih, b, w_hh, H, seq_out, packed)


def f32_packed(layer, route: str, Fa: int):
    """A layer module's cached packed weights for float32 route ``route``
    at inputs split at Fa: packed_narrow_weights (narrow),
    (packed_proj_weights, packed_rec_weights where K1's wgmma recurrence
    takes the layer's H, else None) (split), or None (the in-loop kernel
    reads w_ih and w_hh as they are)."""
    if route == "narrow":
        return packed_narrow_weights(layer)
    if route == "split":
        H = layer.w_hh.shape[1]
        return (packed_proj_weights(layer, Fa),
                packed_rec_weights(layer) if H in _rec.K1W_WIDTHS else None)
    return None


def bilstm_stack_fused_tm(xs, layers, hidden_size: int,
                          compute_dtype: torch.dtype = torch.float32,
                          last_layer_sequence: bool = True,
                          recurrence: str = "kernel"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-major multi-layer BiLSTM (inference: no dropout). ``xs``:
    (T, B, F) or a tuple of them; ``layers``: modules with w_ih, b and
    w_hh (models/bilstm.py::BiLSTMLayer). The (fwd, bwd) halves thread between layers through the
    next layer's row-split projection, so no inter-layer concat is built.
    ``recurrence`` "kernel" runs bilstm_layer_fused (on the card with
    each layer's cached packed weights), "scan" the plain
    version on any device. Returns the last layer's (ys_f, ys_b), each
    (T, B, H), or (1, B, H) when ``last_layer_sequence`` is False."""
    if recurrence not in ("kernel", "scan"):
        raise KeyError(recurrence)
    if not isinstance(xs, (tuple, list)):
        xs = (xs,)
    xs = tuple(x.to(compute_dtype).contiguous() for x in xs)
    on_card = recurrence == "kernel" and xs[0].is_cuda
    n = len(layers)
    for li, p in enumerate(layers):
        seq_out = li < n - 1 or last_layer_sequence
        b = p.b.to(torch.float32).contiguous()
        if on_card and compute_dtype == torch.bfloat16:
            F = sum(x.shape[-1] for x in xs)
            xs = bilstm_layer_fused(
                xs, p.w_ih, b, p.w_hh, hidden_size, seq_out,
                packed=packed_weights(p, packed_for(F, hidden_size,
                                                    xs[0].shape[1])))
            continue
        if on_card and compute_dtype == torch.float32:
            route, _ = f32_route_on(xs[0].device, sum(
                x.shape[-1] for x in xs), hidden_size, xs[0].shape[1])
            xs = bilstm_layer_fused(
                xs, p.w_ih.to(compute_dtype).contiguous(), b,
                p.w_hh.to(compute_dtype).contiguous(), hidden_size, seq_out,
                packed=f32_packed(p, route, xs[0].shape[-1]))
            continue
        layer_fn = (bilstm_layer_fused if recurrence == "kernel"
                    else bilstm_layer_plain)
        xs = layer_fn(xs, p.w_ih.to(compute_dtype).contiguous(), b,
                      p.w_hh.to(compute_dtype).contiguous(), hidden_size,
                      seq_out=seq_out)
    return xs
