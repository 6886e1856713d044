"""Fused BiLSTM layer: the wrapper of the CUDA kernels csrc/fused_bilstm.cu
(counterpart of deepsignal_plant_tpu/ops/pallas_fused.py:104-121 and
:282-330, which run the Pallas kernel ``_fused_kernel``).

Time-major contract, as in the JAX package: inputs (T, B, F) — one array
or the (fwd, bwd) halves of the previous layer, which the kernel reads
against row-split W_ih rows — and outputs (ys_f, ys_b), each (T, B, H) in
true time, or (1, B, H) final states when ``seq_out`` is False.

Two kernels, one per compute dtype, each with its own launch counter:
``fused_bilstm_bf16`` (the main path, on the tensor cores) and
``fused_bilstm_f32`` (exact-parity runs). The bfloat16 kernel reads the
weights packed once per model (``pack_weights``; ``packed_weights``
caches them on the layer module).

A CPU tensor takes the plain version (ops/lstm.py). A CUDA tensor
launches a kernel, or raises: there is no fallback on the card.
"""
from __future__ import annotations

import ctypes
import functools
import torch

from . import _build
from .lstm import bilstm_layer as bilstm_layer_plain

#: launches of each kernel since the last reset (set an entry to 0 to
#: count a run); launches that raise are not counted
launches = {"fused_bilstm_bf16": 0, "fused_bilstm_f32": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HIDDEN = 512


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


def packed_weights(layer) -> torch.Tensor:
    """``pack_weights`` of a layer module (w_ih, w_hh parameters), packed
    once and cached on the module until a parameter changes: the cache
    key holds both parameters' version counters (moved by every in-place
    update, such as an optimizer step) and data pointers."""
    key = (layer.w_ih._version, layer.w_ih.data_ptr(), layer.w_hh._version,
           layer.w_hh.data_ptr())
    cached = layer.__dict__.get("_k1_packed")
    if cached is None or cached[0] != key:
        cached = (key, pack_weights(layer.w_ih, layer.w_hh))
        layer.__dict__["_k1_packed"] = cached
    return cached[1]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_bilstm")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dsp_fused_bilstm_f32.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.dsp_fused_bilstm_bf16.argtypes = [P] * 6 + [I] * 6 + [P]
    for fn in (lib.dsp_fused_bilstm_f32, lib.dsp_fused_bilstm_bf16):
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(xs, w_ih, b, w_hh, H, packed) -> None:
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
    # float32 reads w_ih and w_hh as they are; bfloat16 reads only their
    # packed copy, so they may be of any float dtype there
    wdt = dtype if dtype == torch.float32 else None
    want = {"w_ih": ((2, F, 4 * H), wdt), "w_hh": ((2, H, 4 * H), wdt),
            "b": ((2, 4 * H), torch.float32)}
    named = list(zip(("x", "x2"), xs)) + [
        ("w_ih", w_ih), ("w_hh", w_hh), ("b", b)]
    if packed is not None:
        want["packed"] = ((2, 4 * H, padded_k(F, H)), torch.bfloat16)
        named.append(("packed", packed))
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


def bilstm_layer_fused(xs, w_ih: torch.Tensor, b: torch.Tensor,
                       w_hh: torch.Tensor, hidden_size: int,
                       seq_out: bool = True, packed: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused BiLSTM layer, time-major. ``xs``: a (T, B, F) tensor or a
    tuple of two (their F's concatenate against w_ih's rows), in float32
    or bfloat16; w_ih (2, F, 4H) and w_hh (2, H, 4H) in that dtype (for
    bfloat16, any float dtype: the kernel reads ``packed``, their
    pack_weights, made here when not given); b (2, 4H) float32. Returns
    (ys_f, ys_b), each (T, B, H) in true time, or (1, B, H) final states
    when ``seq_out`` is False."""
    if not isinstance(xs, (tuple, list)):
        xs = (xs,)
    xs = tuple(xs)
    H = hidden_size
    if xs[0].device.type == "cpu":
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    if xs[0].device.type != "cuda":
        raise ValueError(f"fused_bilstm runs on cuda or cpu tensors "
                         f"(got {xs[0].device})")
    _check_inputs(xs, w_ih, b, w_hh, H, packed)
    T, B, Fa = xs[0].shape
    Fb = xs[1].shape[-1] if len(xs) == 2 else 0
    bf16 = xs[0].dtype == torch.bfloat16
    name = "fused_bilstm_bf16" if bf16 else "fused_bilstm_f32"
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


def bilstm_stack_fused_tm(xs, layers, hidden_size: int,
                          compute_dtype: torch.dtype = torch.float32,
                          last_layer_sequence: bool = True,
                          recurrence: str = "kernel"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-major multi-layer BiLSTM (inference: no dropout). ``xs``:
    (T, B, F) or a tuple of them; ``layers``: modules with w_ih, b and
    w_hh (models/bilstm.py::BiLSTMLayer). The (fwd, bwd) halves thread between layers through the
    next layer's row-split projection, so no inter-layer concat is built.
    ``recurrence`` "kernel" runs bilstm_layer_fused (on the card in
    bfloat16 with each layer's cached packed weights), "scan" the plain
    version on any device. Returns the last layer's (ys_f, ys_b), each
    (T, B, H), or (1, B, H) when ``last_layer_sequence`` is False."""
    if recurrence not in ("kernel", "scan"):
        raise KeyError(recurrence)
    if not isinstance(xs, (tuple, list)):
        xs = (xs,)
    xs = tuple(x.to(compute_dtype).contiguous() for x in xs)
    packed_path = (recurrence == "kernel" and xs[0].is_cuda
                   and compute_dtype == torch.bfloat16)
    n = len(layers)
    for li, p in enumerate(layers):
        seq_out = li < n - 1 or last_layer_sequence
        b = p.b.to(torch.float32).contiguous()
        if packed_path:
            xs = bilstm_layer_fused(xs, p.w_ih, b, p.w_hh, hidden_size,
                                    seq_out, packed=packed_weights(p))
            continue
        layer_fn = (bilstm_layer_fused if recurrence == "kernel"
                    else bilstm_layer_plain)
        xs = layer_fn(xs, p.w_ih.to(compute_dtype).contiguous(), b,
                      p.w_hh.to(compute_dtype).contiguous(), hidden_size,
                      seq_out=seq_out)
    return xs
