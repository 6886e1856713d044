"""Checkpoint conversion tools (copy of deepsignal_plant_tpu/tools/ckpt.py).

Replaces scripts/unzip_model_ckpt.py (torch serialization back-compat)
with two-way conversion between reference torch .ckpt files and our native
.npz checkpoints.
"""
from __future__ import annotations

from ..config import ModelConfig
from ..utils.bases import str2bool


def convert_ckpt(model_path: str, out_path: str, direction: str,
                 model_type: str, seq_len: int, signal_len: int,
                 layernum1: int, layernum2: int, hid_rnn: int,
                 is_base: str = "yes", is_signallen: str = "yes") -> str:
    from ..models.convert import (load_any_checkpoint,
                                  params_to_torch_state_dict,
                                  save_checkpoint)
    cfg = ModelConfig(seq_len=seq_len, signal_len=signal_len,
                      num_layers_comb=layernum1, num_layers_branch=layernum2,
                      hidden_size=hid_rnn, module=model_type,
                      is_base=str2bool(is_base),
                      is_signallen=str2bool(is_signallen))
    params = load_any_checkpoint(model_path, cfg)
    if direction == "to_npz":
        if not out_path.endswith(".npz"):
            out_path += ".npz"
        save_checkpoint(out_path, params, cfg)
    elif direction == "to_torch":
        import torch
        sd = params_to_torch_state_dict(params, cfg)
        torch.save({k: torch.tensor(v) for k, v in sd.items()}, out_path)
    else:
        raise ValueError("direction must be to_npz or to_torch")
    print("saved: {}".format(out_path))
    return out_path


def register(tool_sub) -> None:
    p = tool_sub.add_parser(
        "convert_ckpt",
        description="convert checkpoints between torch .ckpt and native "
                    ".npz")
    p.add_argument("--model_path", "-m", type=str, required=True)
    p.add_argument("--out_path", "-o", type=str, required=True)
    p.add_argument("--direction", type=str, default="to_npz",
                   choices=["to_npz", "to_torch"])
    p.add_argument("--model_type", type=str, default="both_bilstm")
    p.add_argument("--seq_len", type=int, default=13)
    p.add_argument("--signal_len", type=int, default=16)
    p.add_argument("--layernum1", type=int, default=3)
    p.add_argument("--layernum2", type=int, default=1)
    p.add_argument("--hid_rnn", type=int, default=256)
    p.add_argument("--is_base", type=str, default="yes")
    p.add_argument("--is_signallen", type=str, default="yes")
    p.set_defaults(func=lambda a: convert_ckpt(
        a.model_path, a.out_path, a.direction, a.model_type, a.seq_len,
        a.signal_len, a.layernum1, a.layernum2, a.hid_rnn, a.is_base,
        a.is_signallen))
