"""Plain PyTorch forward of deepsignal-plant's ModelBiLSTM, written from
its equations (PengNi/deepsignal-plant ``models.py:99-240``, the
``both_bilstm`` module), for the benchmark's comparison. It reads the
state dict in the reference's own layout and imports nothing of the
program.

    seq    = [embed(kmer), means, stds, signal_lens]          (B, L, 7)
    signal = signals                                          (B, L, 16)
    s = relu(fc_seq(BiLSTM_seq(seq)))
    g = relu(fc_signal(BiLSTM_signal(signal)))
    y = BiLSTM_comb([s, g])   (3 layers)     r = [y_fwd[L-1], y_bwd[0]]
    p = softmax(fc2(relu(fc1(r))))

with PyTorch's LSTM cell (gate order i, f, g, o):

    z = x W_ih^T + b_ih + h W_hh^T + b_hh;  i, f, g, o = split(z)
    c = sigmoid(f) c + sigmoid(i) tanh(g);   h = sigmoid(o) tanh(c)

Departure: the initial states are zeros, as in the program (the
reference draws them from ``torch.randn`` at every forward, which no two
runs of it repeat). Dropout is off (inference).

``precision`` rounds every product's two operands before it, the
accumulation staying float32: ``"float32"`` leaves them (TF32 is turned
off for the call), ``"tf32"`` keeps 10 bits of mantissa (round to
nearest, ties away, as the tensor cores' conversion), ``"fp8"`` scales
each operand by its largest magnitude into float8 e4m3 and back: the
lower precisions that the benchmark's controls put in the program's
place.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32", "fp8")
FP8_MAX = 448.0


def _rounder(precision: str):
    if precision == "float32":
        return lambda t: t
    if precision == "tf32":
        def tf32(t):
            bits = t.contiguous().view(torch.int32)
            return ((bits + 0x1000) & -0x2000).view(torch.float32)
        return tf32
    if precision == "fp8":
        def fp8(t):
            scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
            return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) \
                * scale
        return fp8
    raise ValueError(f"precision must be one of {PRECISIONS}")


@contextlib.contextmanager
def _no_tf32():
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def _lstm_direction(x, w_ih, w_hh, b, reverse: bool, rnd):
    """One direction over time-major x (T, B, F) -> (T, B, H)."""
    T, B, _ = x.shape
    H = w_hh.shape[1]
    xp = (rnd(x.reshape(T * B, -1)) @ rnd(w_ih).t()).reshape(T, B, 4 * H) \
        + b
    w_hh = rnd(w_hh).t()
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        z = xp[t] + rnd(h) @ w_hh
        i, f, g, o = z.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out)


def _bilstm(x, sd: dict, name: str, layers: int, rnd):
    for li in range(layers):
        ys = []
        for sfx, reverse in (("", False), ("_reverse", True)):
            k = f"l{li}{sfx}"
            ys.append(_lstm_direction(
                x, sd[f"{name}.weight_ih_{k}"], sd[f"{name}.weight_hh_{k}"],
                sd[f"{name}.bias_ih_{k}"] + sd[f"{name}.bias_hh_{k}"],
                reverse, rnd))
        x = torch.cat(ys, dim=2)
    return x


def _linear(x, sd: dict, name: str, rnd):
    return rnd(x) @ rnd(sd[f"{name}.weight"]).t() + sd[f"{name}.bias"]


def forward(sd: dict, cfg: dict, kmer, means, stds, lens, signals,
            precision: str = "float32"):
    """(logits, probs), (B, classes) float32, of B sites: ``kmer`` (B, L)
    base codes, ``means``/``stds``/``lens`` (B, L), ``signals`` (B, L,
    S), all on one device."""
    rnd = _rounder(precision)
    sd = {k: v.float() for k, v in sd.items()}
    H = int(cfg["hid_rnn"])
    with _no_tf32():
        seq = torch.cat([sd["embed.weight"][kmer.long()],
                         means.float()[..., None], stds.float()[..., None],
                         lens.float()[..., None]], dim=2).transpose(0, 1)
        sig = signals.float().transpose(0, 1)
        s = torch.relu(_linear(_bilstm(seq, sd, "lstm_seq",
                                       int(cfg["layernum2"]), rnd),
                               sd, "fc_seq", rnd))
        g = torch.relu(_linear(_bilstm(sig, sd, "lstm_signal",
                                       int(cfg["layernum2"]), rnd),
                               sd, "fc_signal", rnd))
        y = _bilstm(torch.cat([s, g], dim=2), sd, "lstm_comb",
                    int(cfg["layernum1"]), rnd)
        r = torch.cat([y[-1, :, :H], y[0, :, H:]], dim=1)
        logits = _linear(torch.relu(_linear(r, sd, "fc1", rnd)), sd, "fc2",
                         rnd)
    return logits, torch.softmax(logits, dim=1)


def forward_in_blocks(sd: dict, cfg: dict, kmer, means, stds, lens,
                      signals, precision: str = "float32",
                      block: int = 8192):
    """``forward``'s (logits, probs), ``block`` sites at a time."""
    out = [forward(sd, cfg, *(a[lo:lo + block] for a in (
        kmer, means, stds, lens, signals)), precision=precision)
        for lo in range(0, kmer.shape[0], block)]
    return tuple(torch.cat(parts) for parts in zip(*out))


def probs_in_blocks(sd: dict, cfg: dict, kmer, means, stds, lens, signals,
                    precision: str = "float32", block: int = 8192):
    """``forward``'s probabilities, ``block`` sites at a time."""
    return forward_in_blocks(sd, cfg, kmer, means, stds, lens, signals,
                             precision, block)[1]
