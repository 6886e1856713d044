"""Seeded weights of deepsignal-plant's ModelBiLSTM in its own state-dict
layout (reference models.py:99-240: ``nn.Embedding``, ``nn.LSTM``
bidirectional and batch-first, ``nn.Linear``), made on the device in a
few large draws.

The shapes of PyTorch's default initialisation, U(-g/sqrt(k), g/sqrt(k))
(k the hidden size, or the Linear's inputs), at the gains ``GAIN``; the
embedding N(0, 1). At PyTorch's own gains (1) the untrained model gives
every site nearly the same answer (p1 within 1e-4 of one value on the
benchmark's inputs), so a comparison could not tell one site's answer
from another's; at these, the answers spread as a trained model's do
(p1 from 0.05 to 0.12 between the 5th and 95th percentiles, and a site's
answer moves by up to 0.09 from the mean)."""
from __future__ import annotations

import math

import torch

#: uniform bounds over PyTorch's defaults: the LSTMs' weights and biases,
#: the branch fc layers' and fc1's, fc2's weight and fc2's bias
GAIN = {"lstm": 3.0, "fc": 2.0, "fc2.weight": 8.0, "fc2.bias": 1.0}


def shapes(cfg: dict) -> dict[str, tuple[tuple, float]]:
    """Every state-dict entry's shape and uniform bound (0: N(0, 1))."""
    H = int(cfg["hid_rnn"])
    hs = H // 2                    # each branch's hidden size
    out: dict[str, tuple[tuple, float]] = {
        "embed.weight": ((int(cfg["n_vocab"]), int(cfg["n_embed"])), 0.0)}

    def lstm(name, F, h, layers):
        k = GAIN["lstm"] / math.sqrt(h)
        for li in range(layers):
            f = F if li == 0 else 2 * h
            for sfx in ("", "_reverse"):
                out[f"{name}.weight_ih_l{li}{sfx}"] = ((4 * h, f), k)
                out[f"{name}.weight_hh_l{li}{sfx}"] = ((4 * h, h), k)
                out[f"{name}.bias_ih_l{li}{sfx}"] = ((4 * h,), k)
                out[f"{name}.bias_hh_l{li}{sfx}"] = ((4 * h,), k)

    def linear(name, i, o):
        k = 1 / math.sqrt(i)
        out[f"{name}.weight"] = ((o, i), k * GAIN.get(f"{name}.weight",
                                                      GAIN["fc"]))
        out[f"{name}.bias"] = ((o,), k * GAIN.get(f"{name}.bias",
                                                  GAIN["fc"]))

    seq_in = int(cfg["n_embed"]) + 3
    lstm("lstm_seq", seq_in, hs, int(cfg["layernum2"]))
    linear("fc_seq", 2 * hs, hs)
    lstm("lstm_signal", int(cfg["signal_len"]), H - hs, int(cfg["layernum2"]))
    linear("fc_signal", 2 * (H - hs), H - hs)
    lstm("lstm_comb", H, H, int(cfg["layernum1"]))
    linear("fc1", 2 * H, H)
    linear("fc2", H, int(cfg["class_num"]))
    return out


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The float32 state dict on ``device``: one uniform draw for every
    bounded entry and one normal draw for the embedding."""
    spec = shapes(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    total = sum(math.prod(s) for s, k in spec.values() if k)
    flat = torch.rand(total, generator=g, device=device) * 2 - 1
    sd, off = {}, 0
    for name, (shape, k) in spec.items():
        n = math.prod(shape)
        if k:
            sd[name] = (flat[off:off + n] * k).reshape(shape)
            off += n
        else:
            sd[name] = torch.randn(shape, generator=g, device=device)
    return sd


def save(sd: dict[str, torch.Tensor], path: str) -> None:
    """A ``.ckpt`` as the reference saves one: a plain state dict."""
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)
