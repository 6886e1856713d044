"""ModelBiLSTM — the per-site 5mC classifier, in PyTorch (counterpart of
deepsignal_plant_tpu/models/bilstm.py:39-233 and :236-267).

Architecture (reference deepsignal_plant/models.py:99-240):

- seq branch:    base embedding (16->4) ++ per-base mean/std/len
                 -> BiLSTM(H=nhid_seq) -> Linear(2H->H) -> ReLU
- signal branch: 13x16 raw-signal matrix
                 -> BiLSTM(H=nhid_signal) -> Linear(2H->H) -> ReLU
- combined:      3-layer BiLSTM(H=256) -> readout cat(h_T^fwd, h_T^bwd)
                 -> Linear(512->256) -> ReLU -> Linear(256->2) -> softmax

Inference only, in the JAX package's ``_forward_fused_tm`` structure:
everything runs time-major from the raw (B, T, F<=16) inputs to the
readout; the branch fc layers apply row-split on the (fwd, bwd) halves,
and the comb stack's first layer reads the (out_seq, out_signal) pair
through row-split weights, so no concatenation is built. Initial LSTM
states are zeros (the reference draws randn h0/c0 per forward).

Parameters keep the JAX layouts (w_ih (2, F, 4H), w_hh (2, H, 4H),
b (2, 4H), linear w (in, out)), so a checkpoint of either package loads
with models/convert.py::params_from_numpy.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops.fused_lstm import bilstm_stack_fused_tm
from ..utils.device import torch_dtype


class Batch(NamedTuple):
    """Model inputs; shapes (B, L) / (B, L, S)."""
    kmer: torch.Tensor              # integer base codes
    base_means: torch.Tensor        # float
    base_stds: torch.Tensor         # float
    base_signal_lens: torch.Tensor  # float
    signals: torch.Tensor           # float (B, L, S)


class BiLSTMLayer(nn.Module):
    """The parameters of one bidirectional layer (direction 0 forward)."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        H4 = 4 * hidden_size
        self.w_ih = nn.Parameter(torch.empty(2, input_size, H4,
                                             device=device))
        self.w_hh = nn.Parameter(torch.empty(2, hidden_size, H4,
                                             device=device))
        self.b = nn.Parameter(torch.empty(2, H4, device=device))


class Dense(nn.Module):
    """Linear layer in the right-multiplying layout: y = x @ w + b."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim, device=device))
        self.b = nn.Parameter(torch.empty(out_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w.to(x.dtype) + self.b.to(x.dtype)


class ModelBiLSTM(nn.Module):
    """The classifier; build it with ``from_params`` to load weights."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg

        def stack(in_size: int, H: int, n: int) -> nn.ModuleList:
            return nn.ModuleList(
                BiLSTMLayer(in_size if li == 0 else 2 * H, H, device)
                for li in range(n))

        if cfg.module != "signal_bilstm":
            self.embed = nn.Parameter(torch.empty(
                cfg.vocab_size, cfg.embedding_size, device=device))
            self.lstm_seq = stack(cfg.seq_input_size, cfg.nhid_seq,
                                  cfg.num_layers_branch)
            self.fc_seq = Dense(2 * cfg.nhid_seq, cfg.nhid_seq, device)
        if cfg.module != "seq_bilstm":
            self.lstm_signal = stack(cfg.signal_len, cfg.nhid_signal,
                                     cfg.num_layers_branch)
            self.fc_signal = Dense(2 * cfg.nhid_signal, cfg.nhid_signal,
                                   device)
        # comb layer 0 reads cfg.hidden_size features for every variant
        self.lstm_comb = stack(cfg.hidden_size, cfg.hidden_size,
                               cfg.num_layers_comb)
        self.fc1 = Dense(2 * cfg.hidden_size, cfg.hidden_size, device)
        self.fc2 = Dense(cfg.hidden_size, cfg.num_classes, device)

    @classmethod
    def from_params(cls, params: dict[str, Any], cfg: ModelConfig,
                    device) -> "ModelBiLSTM":
        """An inference-ready model from the parameter pytree (numpy, JAX
        layouts) on ``device``."""
        from .convert import params_from_numpy
        model = cls(cfg, device=device)
        model.load_state_dict(params_from_numpy(params, cfg))
        return model.eval().requires_grad_(False)

    def _branch(self, x: torch.Tensor, layers, fc: Dense, H: int,
                cdt: torch.dtype) -> torch.Tensor:
        """(B, T, F) input -> relu(fc(BiLSTM)) as (T, B, H), with the fc
        applied row-split: relu(cat(f, b) @ W + c) == relu(f @ W[:H] +
        b @ W[H:] + c)."""
        f, b = bilstm_stack_fused_tm(x.transpose(0, 1), layers, H,
                                     compute_dtype=cdt,
                                     recurrence=self.cfg.recurrence)
        w = fc.w.to(cdt)
        return torch.relu(f @ w[:H] + b @ w[H:] + fc.b.to(cdt))

    def forward(self, batch: Batch) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits, softmax probs), both (B, num_classes) float32."""
        cfg = self.cfg
        cdt = torch_dtype(cfg.compute_dtype)
        L = cfg.seq_len
        out_seq = out_signal = None
        if cfg.module != "signal_bilstm":
            feats = [batch.base_means.reshape(-1, L, 1),
                     batch.base_stds.reshape(-1, L, 1)]
            if cfg.is_signallen:
                feats.append(batch.base_signal_lens.reshape(-1, L, 1))
            if cfg.is_base:
                feats = [self.embed[batch.kmer.long()]] + feats
            x_seq = torch.cat([f.to(cdt) for f in feats], dim=2)
            out_seq = self._branch(x_seq, self.lstm_seq, self.fc_seq,
                                   cfg.nhid_seq, cdt)
        if cfg.module != "seq_bilstm":
            out_signal = self._branch(batch.signals.to(cdt),
                                      self.lstm_signal, self.fc_signal,
                                      cfg.nhid_signal, cdt)
        if cfg.module == "seq_bilstm":
            comb_in = out_seq
        elif cfg.module == "signal_bilstm":
            comb_in = out_signal
        else:
            comb_in = (out_seq, out_signal)
        ys_f, ys_b = bilstm_stack_fused_tm(
            comb_in, self.lstm_comb, cfg.hidden_size, compute_dtype=cdt,
            last_layer_sequence=False, recurrence=cfg.recurrence)
        out = torch.cat([ys_f[0], ys_b[0]], dim=-1)        # (B, 2H)
        out = torch.relu(self.fc1(out))
        logits = self.fc2(out).float()
        return logits, torch.softmax(logits, dim=1)


def init_params(cfg: ModelConfig, seed: int = 0) -> dict[str, Any]:
    """A seeded random parameter pytree (numpy, JAX layouts) with the
    distributions of the JAX package's init_params: torch's nn.LSTM and
    nn.Linear defaults, embeddings N(0, 1). The draws differ from
    jax.random's."""
    rng = np.random.default_rng(seed)

    def uniform(shape, k):
        return rng.uniform(-k, k, shape).astype(np.float32)

    def lstm(in_size: int, H: int, n: int) -> list[dict]:
        k = 1.0 / math.sqrt(H)
        return [{"w_ih": uniform((2, in_size if li == 0 else 2 * H, 4 * H), k),
                 "w_hh": uniform((2, H, 4 * H), k),
                 "b": uniform((2, 4 * H), k) + uniform((2, 4 * H), k)}
                for li in range(n)]

    def linear(i: int, o: int) -> dict:
        k = 1.0 / math.sqrt(i)
        return {"w": uniform((i, o), k), "b": uniform((o,), k)}

    params: dict[str, Any] = {}
    if cfg.module != "signal_bilstm":
        params["embed"] = rng.standard_normal(
            (cfg.vocab_size, cfg.embedding_size)).astype(np.float32)
        params["lstm_seq"] = lstm(cfg.seq_input_size, cfg.nhid_seq,
                                  cfg.num_layers_branch)
        params["fc_seq"] = linear(2 * cfg.nhid_seq, cfg.nhid_seq)
    if cfg.module != "seq_bilstm":
        params["lstm_signal"] = lstm(cfg.signal_len, cfg.nhid_signal,
                                     cfg.num_layers_branch)
        params["fc_signal"] = linear(2 * cfg.nhid_signal, cfg.nhid_signal)
    params["lstm_comb"] = lstm(cfg.hidden_size, cfg.hidden_size,
                               cfg.num_layers_comb)
    params["fc1"] = linear(2 * cfg.hidden_size, cfg.hidden_size)
    params["fc2"] = linear(cfg.hidden_size, cfg.num_classes)
    return params


def forward_flops_per_site(cfg: ModelConfig) -> float:
    """Analytic forward FLOPs per site (matmul MACs x2; elementwise and
    embedding lookups excluded — they are <1% of the dot-product work)."""
    T = cfg.seq_len

    def bilstm(in_size: int, H: int, n_layers: int) -> float:
        total = 0.0
        for li in range(n_layers):
            F = in_size if li == 0 else 2 * H
            # per dir per step: (F + H) x 4H MACs; x2 dirs x2 FLOP/MAC
            total += 2 * 2 * T * (F + H) * 4 * H
        return total

    flops = 0.0
    if cfg.module != "signal_bilstm":
        flops += bilstm(cfg.seq_input_size, cfg.nhid_seq,
                        cfg.num_layers_branch)
        flops += 2 * T * (2 * cfg.nhid_seq) * cfg.nhid_seq     # fc_seq
    if cfg.module != "seq_bilstm":
        flops += bilstm(cfg.signal_len, cfg.nhid_signal,
                        cfg.num_layers_branch)
        flops += 2 * T * (2 * cfg.nhid_signal) * cfg.nhid_signal
    flops += bilstm(cfg.hidden_size, cfg.hidden_size, cfg.num_layers_comb)
    flops += 2 * (2 * cfg.hidden_size) * cfg.hidden_size       # fc1
    flops += 2 * cfg.hidden_size * cfg.num_classes             # fc2
    return flops
