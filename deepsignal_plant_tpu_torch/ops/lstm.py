"""Plain PyTorch version of the fused bidirectional LSTM layer
(counterpart of deepsignal_plant_tpu/ops/lstm.py:54-143).

This is the arithmetic the CUDA kernel (csrc/fused_bilstm.cu) must
reproduce, written as an explicit loop over time. The CPU runs it, and
on the card it is what the kernel is held against. It keeps the layer
kernel's numerics contract (ops/pallas_fused.py:78-101):

- gate order i, f, g, o in the packed 4H axis; zero initial h and c;
- one folded bias ``b = b_ih + b_hh``, added in f32;
- products accumulate in f32 (storage-dtype operands are upcast, which
  is exact for bf16), gate math and the cell state stay f32;
- h is rounded to the storage dtype after every step, since that is the
  operand the next step's product reads, and the outputs are stored in
  that dtype.

``torch.nn.LSTM`` is not used: in bf16 it keeps the cell state in bf16.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def bilstm_layer(xs: tuple[torch.Tensor, ...], w_ih: torch.Tensor,
                 b: torch.Tensor, w_hh: torch.Tensor, hidden_size: int,
                 seq_out: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """One bidirectional LSTM layer, time-major.

    xs: 1 or 2 row-split inputs (T, B, F_i) in the storage dtype; their
    F's concatenate against w_ih's rows. w_ih (2, F, 4H), w_hh (2, H, 4H),
    b (2, 4H). Returns (ys_f, ys_b), each (T, B, H) in true time (the
    backward direction's step-t state is row T-1-t), or the (1, B, H)
    final states of each direction when ``seq_out`` is False."""
    H = hidden_size
    T, B, _ = xs[0].shape
    dtype = xs[0].dtype
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
    pre_x = torch.stack([pre_x[0], pre_x[1].flip(0)])    # (2, T, B, 4H)
    w_hh = w_hh.to(f32)
    h = torch.zeros(2, B, H, dtype=f32, device=xs[0].device)
    c = torch.zeros(2, B, H, dtype=f32, device=xs[0].device)
    steps = []
    for s in range(T):
        gates = pre_x[:, s] + torch.bmm(h, w_hh)
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype).to(f32)
        steps.append(h)
    if not seq_out:
        return steps[-1][0:1].to(dtype), steps[-1][1:2].to(dtype)
    ys = torch.stack(steps).to(dtype)                     # (T, 2, B, H)
    return ys[:, 0], ys[:, 1].flip(0)
