"""Fused BiLSTM layer: the wrapper of the CUDA kernels csrc/fused_bilstm.cu
(counterpart of deepsignal_plant_tpu/ops/pallas_fused.py:104-121 and
:282-330, which run the Pallas kernel ``_fused_kernel``).

Time-major contract, as in the JAX package: inputs (T, B, F) — one array
or the (fwd, bwd) halves of the previous layer, which the kernel reads
against row-split W_ih rows — and outputs (ys_f, ys_b), each (T, B, H) in
true time, or (1, B, H) final states when ``seq_out`` is False.

Two routes, one per compute dtype:

- bfloat16 (the main path): one kernel, ``fused_bilstm_bf16`` on the
  tensor cores, input projection inside its time loop, over the weights
  packed once per model (``pack_weights``; ``packed_weights`` caches them
  on the layer module);
- float32 (exact-parity runs): one of two routes per layer, by
  ``f32_inloop``. The split route (``layer_f32_split``) is two launches:
  the input projection out of the time loop, one 3xTF32 wgmma product
  over all T*B rows (``fused_bilstm_proj_f32``, csrc/fused_bilstm.cu)
  into K2's xproj (T, 2, B, 4H), over W_ih packed once per model in tf32
  hi and lo planes (``pack_proj_weights``, cached by
  ``packed_proj_weights``); then ops/recurrence.py::lstm_recurrence_k1,
  K2's float32 kernels storing h as K1 does (``fused_bilstm_rec_f32``,
  or ``fused_bilstm_rec_f32_stream`` off the cluster plans). Layers with
  inputs narrower than the projection's K slab, at batches that fill
  the card, run one launch of the in-loop kernel instead
  (``layer_f32_inloop``, ``fused_bilstm_f32_inloop``: CUDA-core FMAs, the
  projection inside the time loop).

K1's launches all count here, its recurrence's too, not in
ops/recurrence.py's counters, which count the training path.

A CPU tensor takes the plain version (ops/lstm.py). A CUDA tensor
launches the kernels, or raises: there is no fallback on the card.
"""
from __future__ import annotations

import ctypes
import functools
import torch

from . import _build
from . import lstm as plain
from . import recurrence as _rec
from .lstm import bilstm_layer as bilstm_layer_plain

#: launches of each kernel since the last reset (set an entry to 0 to
#: count a run); launches that raise are not counted. A float32 layer
#: launches the in-loop kernel, or the projection kernel and one of the
#: recurrence's two
launches = {"fused_bilstm_bf16": 0, "fused_bilstm_f32_inloop": 0,
            "fused_bilstm_proj_f32": 0, "fused_bilstm_rec_f32": 0,
            "fused_bilstm_rec_f32_stream": 0}

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


def inloop_rows(H: int) -> int:
    """Batch rows of a block of the in-loop float32 kernel
    (csrc/fused_bilstm.cu::launch_f32: 16 rows a thread, 256 // round_up(H,
    32) thread rows a block, at least one)."""
    width = -(-H // 32) * 32
    return 16 * max(1, 256 // width)


def f32_inloop(F: int, H: int, B: int, sms: int) -> bool:
    """Whether a float32 layer runs the in-loop kernel (CUDA-core FMAs,
    the projection inside the time loop) rather than the projection
    kernel and the recurrence: where its input is narrower than one K
    slab of the projection (F < 32: the seq and signal branches' 7 and 16
    raw features, whose xproj would be 4H/F = 32-73 times the input's
    bytes) and its grid, 2 * ceil(B / inloop_rows(H)) blocks, fills the
    card's ``sms`` SMs. On the H100 it was the faster route there at
    4,096 rows and the slower at 1,016 (PERF.md)."""
    return F < 32 and 2 * -(-B // inloop_rows(H)) >= sms


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_bilstm")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dsp_fused_bilstm_f32.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.dsp_fused_bilstm_bf16.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.dsp_fused_bilstm_proj_f32.argtypes = [P] * 6 + [I] * 5 + [P]
    for fn in (lib.dsp_fused_bilstm_f32, lib.dsp_fused_bilstm_bf16,
               lib.dsp_fused_bilstm_proj_f32):
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
    # float32 reads w_hh as it is and w_ih through its packed planes;
    # bfloat16 reads only the packed copy of both, so they may be of any
    # float dtype there
    wdt = dtype if dtype == torch.float32 else None
    want = {"w_ih": ((2, F, 4 * H), wdt), "w_hh": ((2, H, 4 * H), wdt),
            "b": ((2, 4 * H), torch.float32)}
    named = list(zip(("x", "x2"), xs)) + [
        ("w_ih", w_ih), ("w_hh", w_hh), ("b", b)]
    if packed is not None and dtype == torch.bfloat16:
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


def _layer_inputs(xs, w_ih, b, w_hh, H, packed):
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
    _check_inputs(xs, w_ih, b, w_hh, H, packed)
    return xs


def layer_f32_split(xs, w_ih: torch.Tensor, b: torch.Tensor,
                    w_hh: torch.Tensor, hidden_size: int,
                    seq_out: bool = True, packed=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 layer through the split route: input_projection (over
    ``packed``, its pack_proj_weights at this row split, made here when
    not given), then lstm_recurrence_k1. Arguments and result as
    bilstm_layer_fused's; a CPU tensor takes the plain version."""
    H = hidden_size
    checked = _layer_inputs(xs, w_ih, b, w_hh, H, packed)
    if checked is None:
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    if checked[0].dtype != torch.float32:
        raise TypeError("the split route takes float32")
    return _split(checked, w_ih, b, w_hh, H, seq_out, packed)


def _split(xs, w_ih, b, w_hh, H, seq_out, packed):
    return _rec.lstm_recurrence_k1(input_projection(xs, w_ih, b, packed),
                                   w_hh, H, seq_out, launches)


def layer_f32_inloop(xs, w_ih: torch.Tensor, b: torch.Tensor,
                     w_hh: torch.Tensor, hidden_size: int,
                     seq_out: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 layer through the in-loop kernel (one launch, CUDA-core
    FMAs, the input projection inside the time loop). Arguments and
    result as bilstm_layer_fused's; a CPU tensor takes the plain
    version."""
    H = hidden_size
    checked = _layer_inputs(xs, w_ih, b, w_hh, H, None)
    if checked is None:
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    if checked[0].dtype != torch.float32:
        raise TypeError("the in-loop kernel takes float32")
    return _launch(checked, w_ih, b, w_hh, H, seq_out, None)


def _launch(xs, w_ih, b, w_hh, H, seq_out, packed):
    """One launch of the bfloat16 kernel (over ``packed``, made here when
    not given) or of the float32 in-loop kernel, on checked inputs."""
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
    bfloat16, any float dtype: the kernel reads ``packed``, their
    pack_weights, made here when not given; float32's split route reads
    w_ih through ``packed``, its pack_proj_weights at this row split,
    made here when not given); b (2, 4H) float32. float32 takes
    f32_inloop's route. Returns (ys_f, ys_b), each (T, B, H) in true
    time, or (1, B, H) final states when ``seq_out`` is False."""
    H = hidden_size
    checked = _layer_inputs(xs, w_ih, b, w_hh, H, packed)
    if checked is None:
        return bilstm_layer_plain(xs, w_ih, b, w_hh, H, seq_out)
    if checked[0].dtype == torch.bfloat16:
        return _launch(checked, w_ih, b, w_hh, H, seq_out, packed)
    T, B, _ = checked[0].shape
    F = sum(x.shape[-1] for x in checked)
    sms = torch.cuda.get_device_properties(
        checked[0].device).multi_processor_count
    if f32_inloop(F, H, B, sms):
        return _launch(checked, w_ih, b, w_hh, H, seq_out, None)
    return _split(checked, w_ih, b, w_hh, H, seq_out, packed)


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
            xs = bilstm_layer_fused(xs, p.w_ih, b, p.w_hh, hidden_size,
                                    seq_out, packed=packed_weights(p))
            continue
        if on_card and compute_dtype == torch.float32:
            xs = bilstm_layer_fused(
                xs, p.w_ih.to(compute_dtype).contiguous(), b,
                p.w_hh.to(compute_dtype).contiguous(), hidden_size, seq_out,
                packed=packed_proj_weights(p, xs[0].shape[-1]))
            continue
        layer_fn = (bilstm_layer_fused if recurrence == "kernel"
                    else bilstm_layer_plain)
        xs = layer_fn(xs, p.w_ih.to(compute_dtype).contiguous(), b,
                      p.w_hh.to(compute_dtype).contiguous(), hidden_size,
                      seq_out=seq_out)
    return xs
