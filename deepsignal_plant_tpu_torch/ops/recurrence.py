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
  ``bilstm_recurrence_trainable`` picks it under autograd and K2 else.

Tensor contract as the Pallas kernels': xproj (T, 2, B, 4H) with the
bias in it and direction 1 time-flipped, w_hh (2, H, 4H), ys
(T, 2, B, H) in step order, all in float32 or bfloat16 (the storage
dtype); cell states float32. A CPU tensor takes the plain version
(ops/lstm.py); a CUDA tensor launches the kernel or raises: there is no
fallback on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import lstm as plain

#: launches of each kernel since the last reset (set an entry to 0 to
#: count a run); launches that raise are not counted
launches = {"lstm_recurrence_fwd": 0, "lstm_recurrence_fwd_save": 0,
            "lstm_recurrence_bwd": 0, "lstm_dw_hh": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HIDDEN = 512

# dW_hh's split-K plan, for csrc/lstm_recurrence.cu's output tiles of 128
# units by 128 gate columns per direction (kDwM, kDwN there): ranges of K
# rows in multiples of 64 (the bf16 kernel's slab), at most one wave of
# two blocks per SM of the card, and at most 16 splits (their f32
# partials cost bytes). The kernel takes any plan that covers K.
_DW_TILE_M, _DW_TILE_N, _DW_ROW_ALIGN = 128, 128, 64
_DW_BLOCKS_PER_SM, _DW_MAX_SPLITS = 2, 16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_recurrence")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dsp_lstm_recurrence_fwd.argtypes = [P] * 5 + [I] * 5 + [P] * 2
    lib.dsp_lstm_recurrence_bwd.argtypes = [P] * 5 + [I] * 4 + [P] * 2
    lib.dsp_lstm_dw_hh.argtypes = [P] * 3 + [I] * 6 + [P] * 2
    for fn in (lib.dsp_lstm_recurrence_fwd, lib.dsp_lstm_recurrence_bwd,
               lib.dsp_lstm_dw_hh):
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


def _fwd(xproj, w_hh, H, save: bool):
    name = "lstm_recurrence_fwd_save" if save else "lstm_recurrence_fwd"
    T, B, code = _dims(name, xproj, H, 4 * H)
    _check("w_hh", w_hh, (2, H, 4 * H), xproj.dtype)
    dev = xproj.device
    ys = torch.empty((T, 2, B, H), dtype=xproj.dtype, device=dev)
    cs = gates = None
    if save:
        cs = torch.empty((T, 2, B, H), dtype=torch.float32, device=dev)
        gates = torch.empty((T, 2, B, 4 * H), dtype=xproj.dtype, device=dev)
    lib = _lib()
    # bf16: the packed W_hh, written by the launch itself
    ws = torch.empty(lib.dsp_lstm_fwd_workspace_bytes(H, code),
                     dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.dsp_lstm_recurrence_fwd(
            xproj.data_ptr(), w_hh.data_ptr(), ys.data_ptr(),
            cs.data_ptr() if save else None,
            gates.data_ptr() if save else None, T, B, H, int(save), code,
            ws.data_ptr() or None, _stream(xproj))
    _build.check(lib, err, name + " launch")
    launches[name] += 1
    return (ys, cs, gates) if save else ys


def lstm_recurrence(xproj: torch.Tensor, w_hh: torch.Tensor,
                    hidden_size: int) -> torch.Tensor:
    """K2: xproj (T, 2, B, 4H) -> ys (T, 2, B, H), in xproj's dtype."""
    if not _on_card("lstm_recurrence_fwd", xproj, w_hh):
        return plain.lstm_recurrence(xproj, w_hh, hidden_size)
    return _fwd(xproj, w_hh, hidden_size, save=False)


def lstm_recurrence_fwd_save(xproj: torch.Tensor, w_hh: torch.Tensor,
                             hidden_size: int):
    """K3: -> (ys, cs float32, activated gates), ys and gates in xproj's
    dtype."""
    if not _on_card("lstm_recurrence_fwd_save", xproj, w_hh):
        return plain.lstm_recurrence_fwd_save(xproj, w_hh, hidden_size)
    return _fwd(xproj, w_hh, hidden_size, save=True)


def lstm_recurrence_bwd_dx(dys: torch.Tensor, cs: torch.Tensor,
                           gates: torch.Tensor, w_hh: torch.Tensor,
                           hidden_size: int) -> torch.Tensor:
    """K4's recurrence: dys (T, 2, B, H) in the gates' dtype, K3's cs and
    gates -> dxproj (T, 2, B, 4H) in the gates' dtype."""
    name = "lstm_recurrence_bwd"
    if not _on_card(name, gates, dys, cs, w_hh):
        return plain.lstm_recurrence_bwd_dx(dys, cs, gates, w_hh,
                                            hidden_size)
    H = hidden_size
    T, B, code = _dims(name, gates, H, 4 * H)
    _check("dys", dys, (T, 2, B, H), gates.dtype)
    _check("cs", cs, (T, 2, B, H), torch.float32)
    _check("w_hh", w_hh, (2, H, 4 * H), gates.dtype)
    dx = torch.empty_like(gates)
    lib = _lib()
    ws = torch.empty(lib.dsp_lstm_bwd_workspace_bytes(H, code),
                     dtype=torch.uint8, device=gates.device)
    with torch.cuda.device(gates.device):
        err = lib.dsp_lstm_recurrence_bwd(
            dys.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            w_hh.data_ptr(), dx.data_ptr(), T, B, H, code, ws.data_ptr(),
            _stream(gates))
    _build.check(lib, err, name + " launch")
    launches[name] += 1
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
