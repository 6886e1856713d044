"""Fused BiLSTM layer: the wrapper of the CUDA kernel csrc/fused_bilstm.cu
(counterpart of deepsignal_plant_tpu/ops/pallas_fused.py:104-121 and
:282-330, which run the Pallas kernel ``_fused_kernel``).

Time-major contract, as in the JAX package: inputs (T, B, F) — one array
or the (fwd, bwd) halves of the previous layer, which the kernel reads
against row-split W_ih rows — and outputs (ys_f, ys_b), each (T, B, H) in
true time, or (1, B, H) final states when ``seq_out`` is False.

A CPU tensor takes the plain version (ops/lstm.py). A CUDA tensor
launches the kernel, or raises: there is no fallback on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .lstm import bilstm_layer as bilstm_layer_plain

#: launches of the fused_bilstm kernel since the last reset (set it to 0
#: to count a run); launches that raise are not counted
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_bilstm")
    fn = lib.dsp_fused_bilstm_layer
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    ws = lib.dsp_fused_bilstm_workspace_bytes
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_size_t
    return lib


def _check_inputs(xs, w_ih, b, w_hh, H) -> None:
    dev, dtype = xs[0].device, xs[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"fused_bilstm takes float32 or bfloat16 (got {dtype})")
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"fused_bilstm takes 1 or 2 inputs (got {len(xs)})")
    T, B = xs[0].shape[:2]
    for x in xs:
        if x.dim() != 3 or tuple(x.shape[:2]) != (T, B):
            raise ValueError(f"inputs must share (T, B) = {(T, B)}; got "
                             f"{tuple(x.shape)}")
    F = sum(x.shape[-1] for x in xs)
    want = {"w_ih": ((2, F, 4 * H), dtype), "w_hh": ((2, H, 4 * H), dtype),
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
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"{name} must be {shape} {dt}; got "
                                 f"{tuple(t.shape)} {t.dtype}")
        elif t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {dtype}")
    if not 1 <= H <= 512:
        raise ValueError(f"fused_bilstm takes 1 <= H <= 512 (got {H})")


def bilstm_layer_fused(xs, w_ih: torch.Tensor, b: torch.Tensor,
                       w_hh: torch.Tensor, hidden_size: int,
                       seq_out: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused BiLSTM layer, time-major. ``xs``: a (T, B, F) tensor or a
    tuple of two (their F's concatenate against w_ih's rows), in float32
    or bfloat16; w_ih (2, F, 4H) and w_hh (2, H, 4H) in that dtype; b
    (2, 4H) float32. Returns (ys_f, ys_b), each (T, B, H) in true time,
    or (1, B, H) final states when ``seq_out`` is False."""
    global launches
    if not isinstance(xs, (tuple, list)):
        xs = (xs,)
    xs = tuple(xs)
    if xs[0].device.type == "cpu":
        return bilstm_layer_plain(xs, w_ih, b, w_hh, hidden_size, seq_out)
    if xs[0].device.type != "cuda":
        raise ValueError(f"fused_bilstm runs on cuda or cpu tensors "
                         f"(got {xs[0].device})")
    H = hidden_size
    _check_inputs(xs, w_ih, b, w_hh, H)
    T, B, Fa = xs[0].shape
    Fb = xs[1].shape[-1] if len(xs) == 2 else 0
    out_T = T if seq_out else 1
    ys_f = torch.empty((out_T, B, H), dtype=xs[0].dtype, device=xs[0].device)
    ys_b = torch.empty_like(ys_f)
    lib = _lib()
    dtype = _DTYPES[xs[0].dtype]
    # bf16: the kernel's packed weights, written by the launch itself
    workspace = torch.empty(
        lib.dsp_fused_bilstm_workspace_bytes(Fa, Fb, H, dtype),
        dtype=torch.uint8, device=xs[0].device)
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsp_fused_bilstm_layer(
            xs[0].data_ptr(), xs[1].data_ptr() if Fb else None,
            w_ih.data_ptr(), b.data_ptr(), w_hh.data_ptr(),
            ys_f.data_ptr(), ys_b.data_ptr(), T, B, Fa, Fb, H,
            int(seq_out), dtype, workspace.data_ptr() or None, stream)
    _build.check(lib, err, "fused_bilstm launch")
    launches += 1
    return ys_f, ys_b


def bilstm_stack_fused_tm(xs, layers, hidden_size: int,
                          compute_dtype: torch.dtype = torch.float32,
                          last_layer_sequence: bool = True,
                          recurrence: str = "kernel"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-major multi-layer BiLSTM (inference: no dropout). ``xs``:
    (T, B, F) or a tuple of them; ``layers``: modules with w_ih, b and
    w_hh (models/bilstm.py::BiLSTMLayer). The (fwd, bwd) halves thread between layers through the
    next layer's row-split projection, so no inter-layer concat is built.
    ``recurrence`` "kernel" runs bilstm_layer_fused, "scan" the plain
    version on any device. Returns the last layer's (ys_f, ys_b), each
    (T, B, H), or (1, B, H) when ``last_layer_sequence`` is False."""
    layer_fn = {"kernel": bilstm_layer_fused,
                "scan": bilstm_layer_plain}[recurrence]
    if not isinstance(xs, (tuple, list)):
        xs = (xs,)
    xs = tuple(x.to(compute_dtype).contiguous() for x in xs)
    n = len(layers)
    for li, p in enumerate(layers):
        seq_out = li < n - 1 or last_layer_sequence
        xs = layer_fn(xs, p.w_ih.to(compute_dtype).contiguous(),
                      p.b.to(torch.float32).contiguous(),
                      p.w_hh.to(compute_dtype).contiguous(),
                      hidden_size, seq_out=seq_out)
    return xs
