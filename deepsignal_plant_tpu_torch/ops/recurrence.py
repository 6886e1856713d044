"""Trainable BiLSTM recurrence: wrappers of the CUDA kernels in
csrc/lstm_recurrence.cu and their autograd function (counterpart of
deepsignal_plant_tpu/ops/pallas_lstm.py:74-124 and :211-353).

- ``lstm_recurrence`` (K2): the forward alone, the primal of the
  trainable recurrence;
- ``lstm_recurrence_fwd_save`` (K3): the forward that also saves the
  cell states and activated gates;
- ``lstm_recurrence_bwd_dx`` and ``lstm_dw_hh`` (K4): the reverse-time
  recurrence, and the weight gradient as a kernel of its own;
- ``BiLSTMRecurrence``: K3 forward, K4 backward;
  ``bilstm_recurrence_trainable`` picks it under autograd and K2 else;
- ``lstm_recurrence_k1``: the recurrence of K1's float32 route
  (ops/fused_lstm.py), storing h as K1 does: K1's own wgmma kernel, which
  streams W_hh packed in tf32 hi and lo planes to 64-row blocks, or K2's
  float32 kernels (``k1_rec_plan`` picks), counted with K1's kernels, not
  here.

Tensor contract as the Pallas kernels': xproj (T, 2, B, 4H) with the
bias in it and direction 1 time-flipped, w_hh (2, H, 4H), ys
(T, 2, B, H) in step order, all in float32 or bfloat16 (the storage
dtype); cell states float32. A CPU tensor takes the plain version
(ops/lstm.py); a CUDA tensor launches the kernel or raises: there is no
fallback on the card.

K2, K3 and K4's recurrence have two kernels per storage dtype: the
cluster kernels (W_hh resident across a thread-block cluster; float32
runs its products in 3xTF32 on the tensor cores) and the streaming
kernels. ``recurrence_plan`` picks one per launch from the dtype, the
shape and the card's cluster capacity (``cluster_capacity``, its
occupancy query); the launch counters say which ran.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import _build
from . import lstm as plain

#: launches of each kernel since the last reset (set an entry to 0 to
#: count a run); launches that raise are not counted. K2, K3 and K4's
#: recurrence count under their own names where they run the bfloat16
#: cluster kernel, ``<name>_f32`` the float32 cluster kernel,
#: ``<name>_stream`` and ``<name>_f32_stream`` the bfloat16 and float32
#: streaming kernels (recurrence_plan's other side). dW_hh has one kernel
#: per dtype under one name.
launches = {"lstm_recurrence_fwd": 0, "lstm_recurrence_fwd_save": 0,
            "lstm_recurrence_bwd": 0, "lstm_dw_hh": 0,
            "lstm_recurrence_fwd_stream": 0,
            "lstm_recurrence_fwd_save_stream": 0,
            "lstm_recurrence_bwd_stream": 0,
            "lstm_recurrence_fwd_f32": 0,
            "lstm_recurrence_fwd_save_f32": 0,
            "lstm_recurrence_bwd_f32": 0,
            "lstm_recurrence_fwd_f32_stream": 0,
            "lstm_recurrence_fwd_save_f32_stream": 0,
            "lstm_recurrence_bwd_f32_stream": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HIDDEN = 512

# The cluster kernels of csrc/lstm_recurrence.cu; kinds 0 = K2, 1 = K3,
# 2 = K4's recurrence. bfloat16 (kClU, kClLdw there): a block owns 64
# hidden units, a cluster of H/64 = 2 or 4 blocks one row tile of 16, 32
# or 48 rows of one direction. float32 (kClUF, kClLdwF, kClLdaF): a block
# owns 32 units, a cluster of H/32 = 4 or 8 blocks a tile of 16 to 80 rows
# (forward) or 16 to 48 (backward).
_CL_UNITS = {torch.bfloat16: 64, torch.float32: 32}
_CL_SIZES = {torch.bfloat16: (2, 4), torch.float32: (4, 8)}
_CL_ROWS = {torch.bfloat16: ((16, 32, 48),) * 3,
            torch.float32: ((16, 32, 48, 64, 80), (16, 32, 48, 64, 80),
                            (16, 32, 48))}
# the waves of clusters a plan may take: bfloat16 one (else its streaming
# kernel); float32's backward up to two (its streaming kernel is several
# times slower than a second wave of clusters); float32's forward as many
# as the rows need (recurrence_plan)
_CL_WAVES = {torch.bfloat16: 1, torch.float32: 2}
_CL_LDW = 4 * 64 + 8
_CL_LDW_F32, _CL_LDA_F32 = 4 * 32 + 8, 4 * 32 + 4
_MAX_SMEM = 232_448                  # Hopper's shared memory per block
_KIND = {"lstm_recurrence_fwd": 0, "lstm_recurrence_fwd_save": 1,
         "lstm_recurrence_bwd": 2}

# dW_hh's split-K plan, for csrc/lstm_recurrence.cu's output tiles of 128
# units by 128 gate columns per direction (kDwM, kDwN there): ranges of K
# rows in multiples of 64 (the bf16 kernel's slab), at most one wave of
# two blocks per SM of the card (the float32 kernel holds one a SM, so
# two waves), and at most 16 splits (their f32 partials cost bytes; fewer,
# longer splits also sum more rows in one f32 chain). The kernel takes
# any plan that covers K.
_DW_TILE_M, _DW_TILE_N, _DW_ROW_ALIGN = 128, 128, 64
_DW_BLOCKS_PER_SM, _DW_MAX_SPLITS = 2, 16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_recurrence")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dsp_lstm_recurrence_fwd.argtypes = [P] * 5 + [I] * 7 + [P] * 2
    lib.dsp_lstm_recurrence_bwd.argtypes = [P] * 5 + [I] * 6 + [P] * 2
    lib.dsp_lstm_dw_hh.argtypes = [P] * 3 + [I] * 6 + [P] * 2
    lib.dsp_lstm_recurrence_fwd_k1.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.dsp_lstm_recurrence_clusters.argtypes = [I] * 5 + [
        ctypes.POINTER(I)]
    lib.dsp_k1_rec_f32.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.dsp_k1_rec_f32_clusters.argtypes = [I] * 3 + [ctypes.POINTER(I)]
    for fn in (lib.dsp_lstm_recurrence_fwd, lib.dsp_lstm_recurrence_bwd,
               lib.dsp_lstm_dw_hh, lib.dsp_lstm_recurrence_clusters,
               lib.dsp_lstm_recurrence_fwd_k1, lib.dsp_k1_rec_f32,
               lib.dsp_k1_rec_f32_clusters):
        fn.restype = ctypes.c_int
    for fn in (lib.dsp_lstm_fwd_workspace_bytes,
               lib.dsp_lstm_bwd_workspace_bytes):
        fn.argtypes = [I, I]
        fn.restype = ctypes.c_size_t
    lib.dsp_lstm_dw_hh_workspace_bytes.argtypes = [I, I]
    lib.dsp_lstm_dw_hh_workspace_bytes.restype = ctypes.c_size_t
    return lib


def _on_card(what: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA
    tensors that the kernel takes; raises otherwise."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors (got {dev})")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: a tensor is on {t.device}, the "
                             f"first on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    return True


def _check(what: str, t: torch.Tensor, shape: tuple, dtype) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{what} must be {shape} {dtype}; got "
                         f"{tuple(t.shape)} {t.dtype}")


def _dims(what: str, xproj_like: torch.Tensor, H: int, last: int):
    """(T, B, dtype code) of a (T, 2, B, last) storage-dtype tensor."""
    if xproj_like.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 "
                        f"(got {xproj_like.dtype})")
    if not 1 <= H <= _MAX_HIDDEN:
        raise ValueError(f"{what} takes 1 <= H <= {_MAX_HIDDEN} (got {H})")
    if xproj_like.dim() != 4 or xproj_like.shape[1] != 2 or \
            xproj_like.shape[3] != last:
        raise ValueError(f"{what} takes (T, 2, B, {last}); got "
                         f"{tuple(xproj_like.shape)}")
    T, _, B, _ = xproj_like.shape
    return T, B, _DTYPES[xproj_like.dtype]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def recurrence_smem(kind: int, H: int, rows: int,
                    dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared-memory bytes of a block of the cluster kernel ``kind`` (0 =
    K2, 1 = K3, 2 = K4's recurrence) in storage ``dtype`` at hidden size H
    and a row tile of ``rows`` (csrc/lstm_recurrence.cu's cl_smem).
    bfloat16: its W_hh slice (H rows of 4*64 columns, padded to 264); the
    forward's two h buffers (rows x (H + 8)) and its xproj stage (rows x
    264), or the backward's da buffer (rows x 264) and its receive slots
    (H/64 x rows x 64 f32). float32: its W_hh slice (H rows of 4*32
    columns, padded to 136 forward, 132 backward) and the forward's h
    buffer (rows x (H + 4)), or the backward's da buffer (rows x 132) and
    its receive slots (H/32 x rows x 32)."""
    if dtype == torch.float32:
        if kind == 2:
            return 4 * ((H + rows) * _CL_LDA_F32 + rows * H)
        return 4 * (H * _CL_LDW_F32 + rows * (H + 4))
    w = H * _CL_LDW * 2
    if kind == 2:
        return w + rows * _CL_LDW * 2 + (H // 64) * rows * 64 * 4
    return w + (2 * rows * (H + 8) + rows * _CL_LDW) * 2


def recurrence_plan(kind: int, B: int, H: int, capacity,
                    dtype: torch.dtype = torch.bfloat16):
    """(cluster, rows) of the cluster kernel ``kind`` in storage ``dtype``
    for B batch rows, or None for the streaming kernel. ``capacity(cluster,
    rows)`` is how many clusters of that plan the card holds at once (the
    wrapper asks the card: cudaOccupancyMaxActiveClusters). The grid is
    2 * ceil(B / rows) clusters, row tile t covering rows [t*rows,
    min((t+1)*rows, B)) of each direction.

    The shape rule: the cluster kernels fix the units of a block (64 in
    bfloat16, 32 in float32: one W_hh slice fits a block's shared memory
    at either) and take clusters of 2 or 4 (bfloat16) or 4 or 8 (float32)
    blocks, so H = 128 or 256 (the training path's widths); at H = 512 the
    cluster would pass 8 blocks (16 is not portable), and other H are not
    multiples of a block's units. Those take the streaming kernel.

    Among the row tiles that fit shared memory, with ``waves`` = 2 *
    ceil(B / rows) / capacity rounded up: bfloat16, and float32's
    backward, the fewest waves, and among those the smallest tile (shorter
    chains, more SMs), within one wave (bfloat16) or two (float32), else
    the streaming kernel. float32's forward (K2, K3, and K1's recurrence,
    which k1_rec_plan weighs against its wgmma kernel by this cost) the
    least estimated time, waves x
    (ceil(rows / 32) + 0.5), in as many waves as the rows need: a wave's
    time grows with the m16 tiles each warp walks a step (the 8 warps
    split a tile's m16 tiles two ways), plus about half a tile's worth of
    fixed cost (the two cluster barriers and the cell update), as timed on
    the H100 at 1,016 and 4,096 rows (PERF.md); ties take fewer waves. At
    the training batch both rules give the same plans."""
    C = H // _CL_UNITS[dtype]
    if H % _CL_UNITS[dtype] or C not in _CL_SIZES[dtype]:
        return None
    costed = dtype == torch.float32 and kind < 2
    best = None
    for rows in _CL_ROWS[dtype][kind]:
        if recurrence_smem(kind, H, rows, dtype) > _MAX_SMEM:
            continue
        cap = capacity(C, rows)
        if cap < 1:
            continue
        waves = -(-2 * -(-B // rows) // cap)
        if costed:
            cost = (waves * (-(-rows // 32) + 0.5), waves)
        elif waves <= _CL_WAVES[dtype]:
            cost = (waves,)
        else:
            continue
        if best is None or cost < best[0]:
            best = cost, rows
    return None if best is None else (C, best[1])


@functools.cache
def cluster_capacity(device: int, kind: int, H: int, cluster: int,
                     rows: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Clusters of a plan that card ``device`` holds at once (the
    kernel's occupancy query), cached per device and plan."""
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.dsp_lstm_recurrence_clusters(kind, H, cluster, rows,
                                               _DTYPES[dtype],
                                               ctypes.byref(n))
    _build.check(lib, err, "cluster occupancy query")
    return n.value


def _plan(name: str, t: torch.Tensor, B: int, H: int, stream: bool):
    """The plan a launch takes: recurrence_plan on the card's capacity,
    or None (the streaming kernel of the dtype)."""
    if stream:
        return None
    kind, dev, dtype = _KIND[name], t.device.index, t.dtype
    return recurrence_plan(kind, B, H, lambda C, rows: cluster_capacity(
        dev, kind, H, C, rows, dtype), dtype)


# K1's float32 recurrence on wgmma (csrc/lstm_recurrence.cu,
# k1_rec::fwd_f32_kernel): 64-row blocks in clusters of 1, 2 or 4; its
# shared memory is h (64 x H float32), a ring of 2 to 6 stages of 32 KB,
# 12 barriers of 8 bytes and 1,024 bytes of alignment (k1_rec::
# fixed_smem). H 128 or 256: two consumer warpgroups of H / 64 chunks of
# 32 units.
K1W_ROWS, K1W_STAGE_BYTES, K1W_MAX_STAGES = 64, 32768, 6
# the ring a plan takes at each H, where it fits: the fastest on the H100
# at 4,096 and 1,016 rows (PERF.md: 5 of the 5 that fit at H = 256; 4 of
# 6 at H = 128, where 5 and 6 were slower)
K1W_STAGES = {128: 4, 256: 5}
K1W_WIDTHS = tuple(K1W_STAGES)
# cluster sizes, in the order a plan takes them among equal waves
K1W_CLUSTERS = (4, 2, 1)
# one wave of the wgmma kernel in the units of the float32 cluster
# kernel's cost (recurrence_plan: a wave of row tile `rows` costs
# ceil(rows / 32) + 0.5), per H, from the H100's times of both kernels at
# 4,096 and 1,016 rows (PERF.md)
K1W_WAVE_COST = {128: 3.0, 256: 8.6}


def k1w_smem(H: int, stages: int) -> int:
    """Shared-memory bytes of a block of K1's wgmma recurrence at hidden
    size H with a ring of ``stages`` (k1_rec's fixed_smem + the ring)."""
    return K1W_ROWS * H * 4 + stages * K1W_STAGE_BYTES + \
        2 * K1W_MAX_STAGES * 8 + 1024


def k1w_stages(H: int) -> int:
    """Ring stages of K1's wgmma recurrence at H: K1W_STAGES[H], or as
    many as fit beside h where fewer do; 0 where H is not one of
    K1W_WIDTHS or fewer than two fit."""
    if H not in K1W_STAGES:
        return 0
    n = min(K1W_STAGES[H],
            (_MAX_SMEM - k1w_smem(H, 0)) // K1W_STAGE_BYTES)
    return n if n >= 2 else 0


def k1w_plan(B: int, H: int, capacity):
    """(cluster, stages, waves) of K1's wgmma recurrence for B rows, or
    None where it does not take H. ``capacity(cluster, stages)`` is how
    many clusters of that plan the card holds at once (the wrapper asks
    the card, k1w_capacity). Its grid is 2 * round_up(ceil(B / 64),
    cluster) blocks of 64 rows. Among the clusters of K1W_CLUSTERS no
    larger than the row tiles (a cluster shares each weight stage among
    its blocks: bigger ones read W_hh from L2 fewer times), the fewest
    waves, then the first in that order."""
    stages = k1w_stages(H)
    if not stages:
        return None
    tiles = -(-B // K1W_ROWS)
    best = None
    for pref, C in enumerate(K1W_CLUSTERS):
        if C > tiles:
            continue
        cap = capacity(C, stages)
        if cap < 1:
            continue
        waves = -(-2 * -(-tiles // C) // cap)
        if best is None or (waves, pref) < best[0]:
            best = (waves, pref), (C, stages, waves)
    return None if best is None else best[1]


def _f32_fwd_cost(B: int, rows: int, cap: int) -> float:
    """recurrence_plan's estimated time of a float32 forward cluster plan
    of row tile ``rows`` on ``cap`` clusters at once."""
    return -(-2 * -(-B // rows) // cap) * (-(-rows // 32) + 0.5)


_k1_forced = None


@contextlib.contextmanager
def force_k1_rec(kind: str):
    """While this holds, k1_rec_plan takes kernel ``kind`` ("wgmma", K1's
    wgmma recurrence, or "cluster", K2's float32 cluster kernel) wherever
    that kernel has a plan: for timing the two in turns on the same
    path."""
    global _k1_forced
    if kind not in ("wgmma", "cluster"):
        raise KeyError(kind)
    before, _k1_forced = _k1_forced, kind
    try:
        yield
    finally:
        _k1_forced = before


def k1_rec_plan(B: int, H: int, capacity, cl_capacity):
    """The kernel of K1's float32 recurrence for B rows at hidden size H:
    ("wgmma", (cluster, stages)), K1's wgmma recurrence on k1w_plan's
    plan (``capacity`` as it takes); ("cluster", (cluster, rows)), K2's
    float32 cluster kernel on recurrence_plan's plan (``cl_capacity``
    as it takes); or ("stream", None), K2's float32 streaming kernel.
    The least estimated time: the cluster kernel's by recurrence_plan's
    rule, the wgmma kernel's its waves times K1W_WAVE_COST[H] in the same
    units; ties take the cluster kernel. Inside ``force_k1_rec(kind)``
    kernel ``kind`` wherever it has a plan."""
    cl = recurrence_plan(0, B, H, cl_capacity, torch.float32)
    wg = None if _k1_forced == "cluster" and cl else \
        k1w_plan(B, H, capacity)
    if wg is not None and (cl is None or _k1_forced == "wgmma" or
                           wg[2] * K1W_WAVE_COST[H] <
                           _f32_fwd_cost(B, cl[1], cl_capacity(*cl))):
        return "wgmma", wg[:2]
    return ("cluster", cl) if cl else ("stream", None)


@functools.cache
def k1w_capacity(device: int, H: int, cluster: int, stages: int) -> int:
    """Clusters of a plan of K1's wgmma recurrence that card ``device``
    holds at once (the kernel's occupancy query), cached per device and
    plan."""
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.dsp_k1_rec_f32_clusters(H, cluster, stages,
                                          ctypes.byref(n))
    _build.check(lib, err, "K1 wgmma recurrence occupancy query")
    return n.value


def k1_rec_plan_on(device: torch.device, B: int, H: int):
    """k1_rec_plan on the capacities of card ``device``."""
    dev = device.index if device.index is not None else \
        torch.cuda.current_device()
    return k1_rec_plan(
        B, H, lambda C, stages: k1w_capacity(dev, H, C, stages),
        lambda C, rows: cluster_capacity(dev, 0, H, C, rows, torch.float32))


def _counter(name: str, dtype: torch.dtype, plan) -> str:
    """The launch counter of the kernel a launch ran."""
    return name + ("_f32" if dtype == torch.float32 else "") + (
        "" if plan else "_stream")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy where it starts off a 16-byte boundary (the cluster
    kernels read 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd(xproj, w_hh, H, save: bool, stream: bool):
    name = "lstm_recurrence_fwd_save" if save else "lstm_recurrence_fwd"
    T, B, code = _dims(name, xproj, H, 4 * H)
    _check("w_hh", w_hh, (2, H, 4 * H), xproj.dtype)
    plan = _plan(name, xproj, B, H, stream)
    dev = xproj.device
    ys = torch.empty((T, 2, B, H), dtype=xproj.dtype, device=dev)
    cs = gates = None
    if save:
        cs = torch.empty((T, 2, B, H), dtype=torch.float32, device=dev)
        gates = torch.empty((T, 2, B, 4 * H), dtype=xproj.dtype, device=dev)
    lib = _lib()
    # the bf16 streaming kernel's workspace: W_hh packed by the launch
    ws = torch.empty(0 if plan else lib.dsp_lstm_fwd_workspace_bytes(
        H, code), dtype=torch.uint8, device=dev)
    if plan:
        xproj, w_hh = _aligned(xproj), _aligned(w_hh)
    cluster, rows = plan or (0, 0)
    with torch.cuda.device(dev):
        err = lib.dsp_lstm_recurrence_fwd(
            xproj.data_ptr(), w_hh.data_ptr(), ys.data_ptr(),
            cs.data_ptr() if save else None,
            gates.data_ptr() if save else None, T, B, H, int(save), code,
            cluster, rows, ws.data_ptr() or None, _stream(xproj))
    _build.check(lib, err, name + " launch")
    launches[_counter(name, xproj.dtype, plan)] += 1
    return (ys, cs, gates) if save else ys


def lstm_recurrence(xproj: torch.Tensor, w_hh: torch.Tensor,
                    hidden_size: int, stream: bool = False) -> torch.Tensor:
    """K2: xproj (T, 2, B, 4H) -> ys (T, 2, B, H), in xproj's dtype. On
    the card it takes recurrence_plan's kernel, or with ``stream`` the
    dtype's streaming kernel (to time or test the kernel the cluster
    kernel replaces)."""
    if not _on_card("lstm_recurrence_fwd", xproj, w_hh):
        return plain.lstm_recurrence(xproj, w_hh, hidden_size)
    return _fwd(xproj, w_hh, hidden_size, False, stream)


def lstm_recurrence_fwd_save(xproj: torch.Tensor, w_hh: torch.Tensor,
                             hidden_size: int, stream: bool = False):
    """K3: -> (ys, cs float32, activated gates), ys and gates in xproj's
    dtype; ``stream`` as for lstm_recurrence."""
    if not _on_card("lstm_recurrence_fwd_save", xproj, w_hh):
        return plain.lstm_recurrence_fwd_save(xproj, w_hh, hidden_size)
    return _fwd(xproj, w_hh, hidden_size, True, stream)


def lstm_recurrence_k1(xproj: torch.Tensor, w_hh: torch.Tensor,
                       hidden_size: int, seq_out: bool, counts: dict,
                       packed: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's recurrence at float32: K2's arithmetic over xproj (T, 2, B,
    4H) float32, with h stored as K1 stores it: (ys_f, ys_b), each (T, B,
    H) in true time, or (1, B, H) final states when ``seq_out`` is False
    (ops/lstm.py: lstm_recurrence, then k1_outputs). On the card the
    kernel of k1_rec_plan: K1's wgmma recurrence over ``packed``
    (ops/fused_lstm.py::pack_rec_weights of w_hh, made here when not
    given; call_mods' 4096-row tiles), or K2's float32 cluster or
    streaming kernel in K1's output order. The launch counts in
    ``counts`` (ops/fused_lstm.py::launches, with K1's kernels) under
    ``fused_bilstm_rec_f32_wgmma``, ``fused_bilstm_rec_f32`` (cluster
    kernel) or ``fused_bilstm_rec_f32_stream``, never in this module's
    counters, which count the training path."""
    name = "lstm_recurrence_fwd"
    H = hidden_size
    if not _on_card(name, xproj, w_hh):
        return plain.k1_outputs(plain.lstm_recurrence(xproj, w_hh, H),
                                seq_out)
    T, B, _ = _dims(name, xproj, H, 4 * H)
    _check("xproj", xproj, (T, 2, B, 4 * H), torch.float32)
    _check("w_hh", w_hh, (2, H, 4 * H), torch.float32)
    kind, plan = k1_rec_plan_on(xproj.device, B, H)
    dev = xproj.device
    ys_f = torch.empty((T if seq_out else 1, B, H), dtype=torch.float32,
                       device=dev)
    ys_b = torch.empty_like(ys_f)
    lib = _lib()
    if kind == "wgmma":
        if packed is None:
            from .fused_lstm import pack_rec_weights
            packed = pack_rec_weights(w_hh)
        shape = (2, H // 64 * (H // 16), 2, 2, 128, 16)
        if tuple(packed.shape) != shape or packed.dtype != torch.float32 \
                or not packed.is_contiguous() or packed.device != dev \
                or packed.data_ptr() % 16:
            raise ValueError(f"packed must be contiguous 16-byte aligned "
                             f"{shape} float32 on {dev}; got "
                             f"{tuple(packed.shape)} {packed.dtype} on "
                             f"{packed.device}")
        xproj = _aligned(xproj)
        with torch.cuda.device(dev):
            err = lib.dsp_k1_rec_f32(
                xproj.data_ptr(), packed.data_ptr(), ys_f.data_ptr(),
                ys_b.data_ptr(), T, B, H, int(seq_out), *plan,
                _stream(xproj))
        _build.check(lib, err, "K1 wgmma recurrence launch")
        counts["fused_bilstm_rec_f32_wgmma"] += 1
        return ys_f, ys_b
    if plan:
        xproj, w_hh = _aligned(xproj), _aligned(w_hh)
    cluster, rows = plan or (0, 0)
    with torch.cuda.device(dev):
        err = lib.dsp_lstm_recurrence_fwd_k1(
            xproj.data_ptr(), w_hh.data_ptr(), ys_f.data_ptr(),
            ys_b.data_ptr(), T, B, H, int(seq_out), cluster, rows,
            _stream(xproj))
    _build.check(lib, err, "K1 recurrence launch")
    counts["fused_bilstm_rec_f32" + ("" if plan else "_stream")] += 1
    return ys_f, ys_b


def lstm_recurrence_bwd_dx(dys: torch.Tensor, cs: torch.Tensor,
                           gates: torch.Tensor, w_hh: torch.Tensor,
                           hidden_size: int,
                           stream: bool = False) -> torch.Tensor:
    """K4's recurrence: dys (T, 2, B, H) in the gates' dtype, K3's cs and
    gates -> dxproj (T, 2, B, 4H) in the gates' dtype; ``stream`` as for
    lstm_recurrence. The cluster kernels sum their partial products in a
    fixed order: two launches give the same bits."""
    name = "lstm_recurrence_bwd"
    if not _on_card(name, gates, dys, cs, w_hh):
        return plain.lstm_recurrence_bwd_dx(dys, cs, gates, w_hh,
                                            hidden_size)
    H = hidden_size
    T, B, code = _dims(name, gates, H, 4 * H)
    _check("dys", dys, (T, 2, B, H), gates.dtype)
    _check("cs", cs, (T, 2, B, H), torch.float32)
    _check("w_hh", w_hh, (2, H, 4 * H), gates.dtype)
    plan = _plan(name, gates, B, H, stream)
    dx = torch.empty_like(gates)
    lib = _lib()
    ws = torch.empty(0 if plan else lib.dsp_lstm_bwd_workspace_bytes(
        H, code), dtype=torch.uint8, device=gates.device)
    if plan:
        dys, cs, gates, w_hh = map(_aligned, (dys, cs, gates, w_hh))
    cluster, rows = plan or (0, 0)
    with torch.cuda.device(dx.device):
        err = lib.dsp_lstm_recurrence_bwd(
            dys.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            w_hh.data_ptr(), dx.data_ptr(), T, B, H, code, cluster, rows,
            ws.data_ptr() or None, _stream(dx))
    _build.check(lib, err, name + " launch")
    launches[_counter(name, gates.dtype, plan)] += 1
    return dx


def dw_hh_split_plan(T: int, B: int, H: int, sms: int) -> tuple[int, int]:
    """(splits, rows) of the dW_hh kernel on a card of ``sms`` SMs: its
    K = (T-1)*B rows, in step order, cut into ``splits`` contiguous ranges
    of ``rows`` rows (the last one shorter), split z covering
    [z*rows, min((z+1)*rows, K)). As many splits as one wave of blocks
    holds (output tiles times splits <= _DW_BLOCKS_PER_SM * sms), at most
    _DW_MAX_SPLITS; one split of 0 rows when K = 0."""
    K = (T - 1) * B
    if K == 0:
        return 1, 0
    tiles = 2 * -(-H // _DW_TILE_M) * -(-4 * H // _DW_TILE_N)
    want = max(1, min(_DW_MAX_SPLITS, _DW_BLOCKS_PER_SM * sms // tiles))
    rows = -(-K // want)
    rows = -(-rows // _DW_ROW_ALIGN) * _DW_ROW_ALIGN
    return -(-K // rows), rows


def lstm_dw_hh(ys: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """K4's weight gradient: ys (T, 2, B, H), dxproj (T, 2, B, 4H) in one
    storage dtype -> dW_hh (2, H, 4H) float32, bitwise the same from one
    launch to the next (dw_hh_split_plan's partials summed in order)."""
    name = "lstm_dw_hh"
    if not _on_card(name, dx, ys):
        return plain.lstm_dw_hh(ys, dx)
    H = ys.shape[-1]
    T, B, code = _dims(name, dx, H, 4 * H)
    _check("ys", ys, (T, 2, B, H), dx.dtype)
    dw = torch.empty((2, H, 4 * H), dtype=torch.float32, device=dx.device)
    lib = _lib()
    sms = torch.cuda.get_device_properties(dx.device).multi_processor_count
    splits, rows = dw_hh_split_plan(T, B, H, sms)
    ws = torch.empty(lib.dsp_lstm_dw_hh_workspace_bytes(H, splits),
                     dtype=torch.uint8, device=dx.device)
    with torch.cuda.device(dx.device):
        err = lib.dsp_lstm_dw_hh(ys.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                                 T, B, H, splits, rows, code,
                                 ws.data_ptr() or None, _stream(dx))
    _build.check(lib, err, name + " launch")
    launches[name] += 1
    return dw


class BiLSTMRecurrence(torch.autograd.Function):
    """The differentiable recurrence (pallas_lstm.py:317-353): forward K3,
    saving (ys, cs, gates, w_hh); backward K4 -> (dxproj in the storage
    dtype, dW_hh rounded from f32 to w_hh's dtype, as :350 does)."""

    @staticmethod
    def forward(ctx, xproj, w_hh, hidden_size):
        ys, cs, gates = lstm_recurrence_fwd_save(xproj, w_hh, hidden_size)
        ctx.save_for_backward(ys, cs, gates, w_hh)
        ctx.hidden_size = hidden_size
        return ys

    @staticmethod
    def backward(ctx, dys):
        ys, cs, gates, w_hh = ctx.saved_tensors
        dx = lstm_recurrence_bwd_dx(dys.to(gates.dtype).contiguous(), cs,
                                    gates, w_hh, ctx.hidden_size)
        dw = lstm_dw_hh(ys, dx)
        return dx, dw.to(w_hh.dtype), None


def bilstm_recurrence_trainable(xproj: torch.Tensor, w_hh: torch.Tensor,
                                hidden_size: int) -> torch.Tensor:
    """ys (T, 2, B, H) of the recurrence: under autograd (grad enabled and
    an input that needs it) K3 with K4 as its backward, else K2 — the JAX
    custom VJP's primal."""
    if torch.is_grad_enabled() and (xproj.requires_grad
                                    or w_hh.requires_grad):
        return BiLSTMRecurrence.apply(xproj, w_hh, hidden_size)
    return lstm_recurrence(xproj, w_hh, hidden_size)
