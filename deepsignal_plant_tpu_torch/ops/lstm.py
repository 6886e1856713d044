"""Plain PyTorch versions of the BiLSTM kernels, and the batch-major
training layers (counterpart of deepsignal_plant_tpu/ops/lstm.py:54-170
and ops/pallas_lstm.py:40-71, :131-208).

These are the arithmetic the CUDA kernels must reproduce, written as
explicit loops over time. The CPU runs them, and on the card they are
what the kernels are held against:

- ``bilstm_layer``: the fused layer of csrc/fused_bilstm.cu (K1), input
  projection included, time-major, in true time; it is
  ``input_projection`` (the float32 route's projection kernel), the
  recurrence, and ``k1_outputs`` (the order K1 stores h in);
- ``lstm_recurrence`` (K2), ``lstm_recurrence_fwd_save`` (K3),
  ``lstm_recurrence_bwd`` (K4, as its two halves ``lstm_recurrence_bwd_dx``
  and ``lstm_dw_hh``): the recurrence alone over a precomputed xproj
  (T, 2, B, 4H) with the bias in it and direction 1 time-flipped, as the
  Pallas kernels of ops/pallas_lstm.py take it (csrc/lstm_recurrence.cu).

All keep the kernels' numerics contract (ops/pallas_fused.py:78-101,
ops/pallas_lstm.py:40-54, :181-208):

- gate order i, f, g, o in the packed 4H axis; zero initial h and c;
- products accumulate in f32 (storage-dtype operands are upcast, which
  is exact for bf16), gate math, the cell state and the dh/dc carries
  stay f32;
- h is rounded to the storage dtype after every step, since that is the
  operand the next step's product reads; the saved gates, dxproj and the
  da that feeds dh_{t-1} and dW_hh are rounded to it too.

``torch.nn.LSTM`` is not used: in bf16 it keeps the cell state in bf16.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def _scan(pre: torch.Tensor, w_hh: torch.Tensor, H: int, dtype: torch.dtype,
          save: bool):
    """The recurrence over f32 pre-activations ``pre`` (T, 2, B, 4H), step
    order for both directions, that still lack the h_{s-1} @ W_hh term.
    Returns ys (T, 2, B, H) in ``dtype`` and, with ``save``, the cell
    states (T, 2, B, H) f32 and activated gates (T, 2, B, 4H) in
    ``dtype``."""
    T, _, B, _ = pre.shape
    w = w_hh.to(f32)
    h = torch.zeros(2, B, H, dtype=f32, device=pre.device)
    c = torch.zeros(2, B, H, dtype=f32, device=pre.device)
    ys, cs, gs = [], [], []
    for s in range(T):
        a = pre[s] + torch.bmm(h, w)
        i, f, g, o = a.split(H, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = (o * torch.tanh(c)).to(dtype).to(f32)
        ys.append(h)
        if save:
            cs.append(c)
            gs.append(torch.cat([i, f, g, o], dim=-1))
    ys = torch.stack(ys).to(dtype)
    if not save:
        return ys
    return ys, torch.stack(cs), torch.stack(gs).to(dtype)


def bilstm_layer(xs: tuple[torch.Tensor, ...], w_ih: torch.Tensor,
                 b: torch.Tensor, w_hh: torch.Tensor, hidden_size: int,
                 seq_out: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """One bidirectional LSTM layer, time-major (K1's plain version).

    xs: 1 or 2 row-split inputs (T, B, F_i) in the storage dtype; their
    F's concatenate against w_ih's rows. w_ih (2, F, 4H), w_hh (2, H, 4H),
    b (2, 4H), added in f32. Returns (ys_f, ys_b), each (T, B, H) in true
    time (the backward direction's step-t state is row T-1-t), or the
    (1, B, H) final states of each direction when ``seq_out`` is False."""
    pre_x = input_projection(xs, w_ih, b)
    ys = _scan(pre_x, w_hh, hidden_size, xs[0].dtype, save=False)
    return k1_outputs(ys, seq_out)


def input_projection(xs: tuple[torch.Tensor, ...], w_ih: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """K1's input projection in K2's contract (the plain version of the
    float32 route's projection kernel, csrc/fused_bilstm.cu): xs 1 or 2
    row-split inputs (T, B, F_i), w_ih (2, F, 4H), b (2, 4H) -> xproj
    (T, 2, B, 4H) float32 = b[d] + sum_i x_i[t] @ w_ih[d][rows_i], where
    step s of direction 1 reads time t = T-1-s."""
    if sum(x.shape[-1] for x in xs) != w_ih.shape[1]:
        raise ValueError("inputs have {} features, w_ih has {} rows".format(
            [x.shape[-1] for x in xs], w_ih.shape[1]))
    w = w_ih.to(f32)
    pre_x = b.to(f32)[:, None, None, :]                   # (2, 1, 1, 4H)
    row = 0
    for x in xs:
        F = x.shape[-1]
        pre_x = pre_x + torch.einsum("tbf,dfg->dtbg", x.to(f32),
                                     w[:, row:row + F])
        row += F
    # step s of direction 1 reads time T-1-s
    return torch.stack([pre_x[0], pre_x[1].flip(0)], dim=1)


def k1_outputs(ys: torch.Tensor, seq_out: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's ys (T, 2, B, H) in step order -> K1's outputs: (ys_f, ys_b),
    each (T, B, H) in true time, or the (1, B, H) final states of each
    direction when ``seq_out`` is False."""
    if not seq_out:
        return ys[-1, 0:1], ys[-1, 1:2]
    return ys[:, 0], ys[:, 1].flip(0)


def lstm_recurrence(xproj: torch.Tensor, w_hh: torch.Tensor,
                    hidden_size: int) -> torch.Tensor:
    """K2: xproj (T, 2, B, 4H) -> ys (T, 2, B, H) in xproj's dtype, in
    step order (direction 1 stays time-flipped)."""
    return _scan(xproj.to(f32), w_hh, hidden_size, xproj.dtype, save=False)


def lstm_recurrence_fwd_save(xproj: torch.Tensor, w_hh: torch.Tensor,
                             hidden_size: int):
    """K3: K2 plus the residuals of the backward -> (ys, cs, gates):
    ys (T, 2, B, H) and the activated gates (T, 2, B, 4H) in xproj's
    dtype, the cell states cs (T, 2, B, H) in float32."""
    return _scan(xproj.to(f32), w_hh, hidden_size, xproj.dtype, save=True)


def lstm_recurrence_bwd_dx(dys: torch.Tensor, cs: torch.Tensor,
                           gates: torch.Tensor, w_hh: torch.Tensor,
                           hidden_size: int) -> torch.Tensor:
    """K4, the reverse-time recurrence (ops/pallas_lstm.py:181-206): the
    cotangent dys (T, 2, B, H) and K3's residuals -> dxproj (T, 2, B, 4H)
    in the gates' dtype."""
    H = hidden_size
    dtype = gates.dtype
    T, _, B, _ = gates.shape
    w_t = w_hh.to(f32).transpose(1, 2)                    # (2, 4H, H)
    dh = torch.zeros(2, B, H, dtype=f32, device=gates.device)
    dc = torch.zeros_like(dh)
    dx = [None] * T
    for s in reversed(range(T)):
        i, f, g, o = gates[s].to(f32).split(H, dim=-1)
        c_prev = cs[s - 1] if s > 0 else torch.zeros_like(dh)
        tanh_c = torch.tanh(cs[s])
        dh_t = dys[s].to(f32) + dh
        dc_t = dc + dh_t * o * (1.0 - tanh_c * tanh_c)
        da = torch.cat([dc_t * g * i * (1.0 - i),
                        dc_t * c_prev * f * (1.0 - f),
                        dc_t * i * (1.0 - g * g),
                        dh_t * tanh_c * o * (1.0 - o)], dim=-1).to(dtype)
        dx[s] = da
        dh = torch.bmm(da.to(f32), w_t)
        dc = dc_t * f
    return torch.stack(dx)


def lstm_dw_hh(ys: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """K4, the weight gradient: dW_hh (2, H, 4H) float32 = sum over steps
    s >= 1 and rows of ys[s-1]^T @ dx[s] (h_{-1} = 0)."""
    return torch.einsum("sdbh,sdbg->dhg", ys[:-1].to(f32), dx[1:].to(f32))


def lstm_recurrence_bwd(dys, ys, cs, gates, w_hh, hidden_size):
    """K4 (ops/pallas_lstm.py::_recurrence_bwd): -> (dxproj in the gates'
    dtype, dW_hh float32)."""
    dx = lstm_recurrence_bwd_dx(dys.to(gates.dtype), cs, gates, w_hh,
                                hidden_size)
    return dx, lstm_dw_hh(ys, dx)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout (models/bilstm.py:101-104): keep each element with
    probability 1 - rate, scaled by 1 / (1 - rate), in x's dtype. The
    mask comes from ``generator`` (on x's device)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def bilstm_layer_bm(x: torch.Tensor, layer, hidden_size: int,
                    recurrence_fn, compute_dtype: torch.dtype,
                    return_sequence: bool = True) -> torch.Tensor:
    """One bidirectional layer, batch-major, for training
    (ops/lstm.py:94-143 with impl="pallas"). x (B, T, F) -> (B, T, 2H), or
    the final states cat(h_T^fwd, h_T^bwd) (B, 2H) when not
    ``return_sequence``. The input projection is one einsum in the
    compute dtype with the bias added in that dtype; ``recurrence_fn``
    (xproj (T, 2, B, 4H), w_hh, H) -> ys runs the recurrence (the kernels'
    autograd function, or the plain lstm_recurrence)."""
    cdt = compute_dtype
    xproj = torch.einsum("btf,dfg->dbtg", x.to(cdt), layer.w_ih.to(cdt))
    xproj = xproj + layer.b[:, None, None, :].to(cdt)
    xproj = torch.stack([xproj[0], xproj[1].flip(1)])     # flip direction 1
    xproj = xproj.permute(2, 0, 1, 3).contiguous()        # (T, 2, B, 4H)
    ys = recurrence_fn(xproj, layer.w_hh.to(cdt), hidden_size)
    if not return_sequence:
        h_T = ys[-1]
        return torch.cat([h_T[0], h_T[1]], dim=-1)
    fwd = ys[:, 0].transpose(0, 1)                        # (B, T, H)
    bwd = ys[:, 1].flip(0).transpose(0, 1)
    return torch.cat([fwd, bwd], dim=-1)


def bilstm_stack(x: torch.Tensor, layers, hidden_size: int, recurrence_fn,
                 compute_dtype: torch.dtype, last_layer_sequence: bool = True,
                 dropout_rate: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Multi-layer batch-major BiLSTM (ops/lstm.py:146-170): with a
    ``generator``, dropout on every layer's output but the last."""
    out = x
    n = len(layers)
    for li, layer in enumerate(layers):
        is_last = li == n - 1
        out = bilstm_layer_bm(out, layer, hidden_size, recurrence_fn,
                              compute_dtype,
                              return_sequence=not is_last
                              or last_layer_sequence)
        if generator is not None and dropout_rate > 0.0 and not is_last:
            out = dropout(out, dropout_rate, generator)
    return out
