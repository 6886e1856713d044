"""Checkpoint I/O (copy of deepsignal_plant_tpu/models/convert.py:45-263).

Both packages read and write one format: an ``.npz`` of the parameter
pytree in the JAX layouts, with the model config as a JSON blob under
``__config__``. The reference's torch ``state_dict`` checkpoints (the
published ``model.dp2.CNN...both_bilstm.epoch6`` family) convert into
the same pytree.

torch tensor layouts (nn.LSTM / nn.Linear docs, and reference models.py):
    lstm.weight_ih_l{k}[_reverse] : (4H, in)   gate order i, f, g, o
    lstm.weight_hh_l{k}[_reverse] : (4H, H)
    lstm.bias_ih/hh_l{k}[_reverse]: (4H,)
    linear.weight                 : (out, in)
The pytree's layouts right-multiply (x @ W), direction-stacked:
    w_ih: (2, in, 4H)   w_hh: (2, H, 4H)   b: (2, 4H) = b_ih + b_hh
    linear w: (in, out)
The port's modules keep these layouts (models/bilstm.py), so
``params_from_numpy`` only flattens the pytree into a state dict and
``params_to_numpy`` unflattens a state dict back into it.
"""
from __future__ import annotations

import json
import zipfile
from typing import Any

import numpy as np
import torch

from ..config import ModelConfig

Params = dict[str, Any]


def _flatten(params: Params, prefix: str = "", sep: str = "/"
             ) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + sep, sep))
        elif isinstance(v, list):
            for i, item in enumerate(v):
                flat.update(_flatten(item, f"{key}{sep}{i}{sep}", sep))
        else:
            flat[key] = np.asarray(v)
    return flat


def _unflatten(flat: dict[str, np.ndarray]) -> Params:
    """Inverse of _flatten: numeric path parts index lists."""
    root: Params = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node: Any = root
        for i, p in enumerate(parts):
            last = i == len(parts) - 1
            nxt: Any = None if last else ([] if parts[i + 1].isdigit()
                                          else {})
            if isinstance(node, list):
                p = int(p)
                while len(node) <= p:
                    node.append(None)
                if last:
                    node[p] = arr
                elif node[p] is None:
                    node[p] = nxt
                node = node[p]
            else:
                if last:
                    node[p] = arr
                else:
                    node = node.setdefault(p, nxt)
    return root


def save_checkpoint(path: str, params: Params, cfg: ModelConfig | None = None
                    ) -> None:
    """Save params (and optionally the model config) to one .npz file that
    both packages load."""
    flat = _flatten(params)
    if cfg is not None:
        flat["__config__"] = np.frombuffer(
            json.dumps(cfg.to_json_dict()).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_checkpoint(path: str) -> tuple[Params, ModelConfig | None]:
    """Load a native .npz checkpoint -> (params, config-or-None). An
    embedded recurrence of "pallas" (the JAX package's fused kernel)
    maps to "kernel"."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    cfg = None
    if "__config__" in flat:
        cfg = ModelConfig.from_json_dict(
            json.loads(bytes(flat.pop("__config__")).decode()))
    return _unflatten(flat), cfg


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def _convert_lstm(sd: dict, torch_prefix: str, num_layers: int) -> list[Params]:
    layers = []
    for li in range(num_layers):
        w_ih, w_hh, b = [], [], []
        for suffix in ("", "_reverse"):
            wi = _np(sd[f"{torch_prefix}.weight_ih_l{li}{suffix}"])
            wh = _np(sd[f"{torch_prefix}.weight_hh_l{li}{suffix}"])
            bi = _np(sd[f"{torch_prefix}.bias_ih_l{li}{suffix}"])
            bh = _np(sd[f"{torch_prefix}.bias_hh_l{li}{suffix}"])
            w_ih.append(wi.T)          # (in, 4H)
            w_hh.append(wh.T)          # (H, 4H)
            b.append(bi + bh)
        layers.append({"w_ih": np.stack(w_ih), "w_hh": np.stack(w_hh),
                       "b": np.stack(b)})
    return layers


def _convert_linear(sd: dict, torch_prefix: str) -> Params:
    return {"w": _np(sd[f"{torch_prefix}.weight"]).T,
            "b": _np(sd[f"{torch_prefix}.bias"])}


def _expected_torch_keys(cfg: ModelConfig) -> set[str]:
    """The exact state_dict keys the converter consumes for this config."""
    keys: set[str] = set()

    def lstm(name: str, num_layers: int) -> None:
        for li in range(num_layers):
            for suffix in ("", "_reverse"):
                for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    keys.add(f"{name}.{w}_l{li}{suffix}")

    def linear(name: str) -> None:
        keys.add(f"{name}.weight")
        keys.add(f"{name}.bias")

    if cfg.module != "signal_bilstm":
        keys.add("embed.weight")
        lstm("lstm_seq", cfg.num_layers_branch)
        linear("fc_seq")
    if cfg.module != "seq_bilstm":
        lstm("lstm_signal", cfg.num_layers_branch)
        linear("fc_signal")
    lstm("lstm_comb", cfg.num_layers_comb)
    linear("fc1")
    linear("fc2")
    return keys


def normalize_torch_state_dict(sd: dict, cfg: ModelConfig) -> dict:
    """Strip DataParallel ``module.`` prefixes and audit the key set: a
    checkpoint missing weights is a hard error with a full report (the
    reference's filtered-dict update would run with whatever sat in those
    slots); keys not consumed (e.g. extra buffers) are ignored."""
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    expected = _expected_torch_keys(cfg)
    present = set(sd.keys())
    missing = sorted(expected - present)
    if missing:
        unexpected = sorted(present - expected)
        raise ValueError(
            "torch checkpoint does not match model config "
            f"(module={cfg.module!r}, layers={cfg.num_layers_branch}/"
            f"{cfg.num_layers_comb}):\n"
            f"  missing keys ({len(missing)}): {missing}\n"
            f"  unexpected keys ({len(unexpected)}): {unexpected}")
    return sd


def convert_torch_state_dict(sd: dict, cfg: ModelConfig) -> Params:
    """Map a reference torch state_dict onto the parameter pytree."""
    sd = normalize_torch_state_dict(sd, cfg)
    params: Params = {}
    if cfg.module != "signal_bilstm":
        params["embed"] = _np(sd["embed.weight"])
        params["lstm_seq"] = _convert_lstm(sd, "lstm_seq",
                                           cfg.num_layers_branch)
        params["fc_seq"] = _convert_linear(sd, "fc_seq")
    if cfg.module != "seq_bilstm":
        params["lstm_signal"] = _convert_lstm(sd, "lstm_signal",
                                              cfg.num_layers_branch)
        params["fc_signal"] = _convert_linear(sd, "fc_signal")
    params["lstm_comb"] = _convert_lstm(sd, "lstm_comb", cfg.num_layers_comb)
    params["fc1"] = _convert_linear(sd, "fc1")
    params["fc2"] = _convert_linear(sd, "fc2")
    return params


def load_torch_checkpoint(path: str, cfg: ModelConfig) -> Params:
    """Load a reference .ckpt (torch serialized state_dict) and convert.
    Loads with ``weights_only=True``: no pickle code from the file runs."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:
        raise RuntimeError(
            "safe (weights_only) torch load of {} failed ({}: {}); re-save "
            "the checkpoint as a plain state_dict on a trusted host".format(
                path, type(exc).__name__, exc)) from exc
    if not isinstance(sd, dict):
        sd = sd.state_dict()
    return convert_torch_state_dict(sd, cfg)


def _is_native_npz(path: str) -> bool:
    """True iff the file is a numpy .npz archive (vs a torch zip ckpt):
    npz members are all ``*.npy``; torch archives carry ``data.pkl``."""
    try:
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
    except zipfile.BadZipFile:
        return False
    return bool(names) and all(n.endswith(".npy") for n in names)


def load_any_checkpoint(path: str, cfg: ModelConfig) -> Params:
    """Dispatch on file type: .npz native checkpoints, else torch."""
    if path.endswith(".npz") or _is_native_npz(path):
        params, _ = load_checkpoint(path)
        return params
    return load_torch_checkpoint(path, cfg)


def params_from_numpy(params: Params, cfg: ModelConfig
                      ) -> dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (numpy arrays in the JAX
    layouts) -> a float32 state dict for models.bilstm.ModelBiLSTM(cfg),
    whose modules keep those layouts. Raises on a missing, unexpected or
    misshapen leaf."""
    from .bilstm import ModelBiLSTM
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in _flatten(params, sep=".").items()}
    want = {k: tuple(v.shape) for k, v in
            ModelBiLSTM(cfg, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != want:
        raise ValueError(
            "parameters do not match model config (module={!r}): "
            "missing {}, unexpected {}, misshapen {}".format(
                cfg.module, sorted(set(want) - set(got)),
                sorted(set(got) - set(want)),
                sorted(k for k in set(got) & set(want)
                       if got[k] != want[k])))
    return sd


def params_to_numpy(model: torch.nn.Module) -> Params:
    """Inverse of params_from_numpy: a ModelBiLSTM's parameters -> the
    parameter pytree (numpy float32, JAX layouts) that save_checkpoint
    writes and both packages load."""
    flat = {k.replace(".", "/"): v.detach().to("cpu", torch.float32).numpy()
            for k, v in model.state_dict().items()}
    return _unflatten(flat)
