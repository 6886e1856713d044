"""Operations and bytes of the model's forward, from the configuration's
shapes (copied from chip_smoke.py's ``layer_bound`` and from
``forward_flops_per_site`` of the program's models/bilstm.py), and the
least time they need on the chip.

Products count 2 FLOP a multiply-add, once, whatever implements them (a
3xTF32 route runs each float32 product three times; that is its cost,
not the work). Bytes count each input read once, the weights once a
launch, and each output written once."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Layer:
    name: str
    F: int          # input features
    H: int          # hidden size of each direction
    seq_out: bool   # all T steps written (False: the final states only)


def lstm_layers(cfg: dict) -> list[Layer]:
    """The forward's bidirectional LSTM layers (both_bilstm)."""
    H = int(cfg["hid_rnn"])
    hs = H // 2
    out = []
    for li in range(int(cfg["layernum2"])):
        out.append(Layer(f"seq{li}", (int(cfg["n_embed"]) + 3) if li == 0
                         else 2 * hs, hs, True))
    for li in range(int(cfg["layernum2"])):
        out.append(Layer(f"signal{li}", int(cfg["signal_len"]) if li == 0
                         else 2 * (H - hs), H - hs, True))
    n = int(cfg["layernum1"])
    for li in range(n):
        out.append(Layer(f"comb{li}", H if li == 0 else 2 * H, H,
                         li < n - 1))
    return out


def layer_flops_per_site(layer: Layer, T: int) -> float:
    """Both directions' input and recurrent products over T steps."""
    return 2 * 2 * T * (layer.F + layer.H) * 4 * layer.H


def forward_flops_per_site(cfg: dict) -> float:
    """The whole forward a site: the LSTM layers, the branch fc layers
    at every step, fc1 and fc2 (elementwise work and lookups left out,
    under 1% of the products)."""
    T = int(cfg["seq_len"])
    H = int(cfg["hid_rnn"])
    hs = H // 2
    flops = sum(layer_flops_per_site(l, T) for l in lstm_layers(cfg))
    flops += 2 * T * (2 * hs) * hs + 2 * T * (2 * (H - hs)) * (H - hs)
    flops += 2 * (2 * H) * H + 2 * H * int(cfg["class_num"])
    return flops


def layer_bytes(layer: Layer, T: int, rows: int, launches: int,
                itemsize: int) -> float:
    """Compulsory bytes of ``launches`` launches of a layer over ``rows``
    rows in all: the input and the output once a row, W_ih and W_hh in
    the compute dtype and the float32 bias once a launch."""
    F, H = layer.F, layer.H
    out_T = T if layer.seq_out else 1
    per_row = T * F * itemsize + 2 * out_T * H * itemsize
    per_launch = 2 * (F + H) * 4 * H * itemsize + 2 * 4 * H * 4
    return rows * per_row + launches * per_launch


def lstm_bound_seconds(cfg: dict, rows: int, tiles: int, itemsize: int,
                       peak_flops: float, peak_bytes: float) -> float:
    """The least time of the forward's LSTM layers over ``rows`` rows in
    ``tiles`` forward tiles: a layer's products at the peak rate or its
    bytes at the memory rate, whichever is longer, summed over layers."""
    T = int(cfg["seq_len"])
    total = 0.0
    for layer in lstm_layers(cfg):
        total += max(layer_flops_per_site(layer, T) * rows / peak_flops,
                     layer_bytes(layer, T, rows, tiles, itemsize)
                     / peak_bytes)
    return total
