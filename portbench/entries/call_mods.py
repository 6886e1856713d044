"""Entry ``call_mods``: the program's ``CallModsEngine``, the engine the
``call_mods`` CLI runs, built once in set-up from the benchmark's
``.ckpt`` (converted on load, as the released checkpoint is); a pass is
one ``run_features_file`` call over the cell's whole input, its rows
written through the engine's own writer.

Options (a workload file's ``options``): ``transfer_dtype``,
``device_batch``, ``device_resident`` and ``parse_workers`` (null: the
program's default), as the CLI's flags of those names."""
from __future__ import annotations

import dataclasses

from deepsignal_plant_tpu_torch.config import CallConfig, ModelConfig
from deepsignal_plant_tpu_torch.pipeline.call_mods import CallModsEngine
from deepsignal_plant_tpu_torch.utils.device import resolve_compute_dtype


def model_config(cfg: dict, device) -> ModelConfig:
    """The program's ModelConfig of a benchmark configuration (the CLI's
    model flags)."""
    return ModelConfig(
        seq_len=int(cfg["seq_len"]), signal_len=int(cfg["signal_len"]),
        num_layers_comb=int(cfg["layernum1"]),
        num_layers_branch=int(cfg["layernum2"]),
        num_classes=int(cfg["class_num"]), dropout_rate=0.0,
        hidden_size=int(cfg["hid_rnn"]), vocab_size=int(cfg["n_vocab"]),
        embedding_size=int(cfg["n_embed"]), is_base=bool(cfg["is_base"]),
        is_signallen=bool(cfg["is_signallen"]), module=cfg["model_type"],
        compute_dtype=resolve_compute_dtype(cfg["compute_dtype"], device),
        recurrence="kernel")


class Entry:
    def __init__(self, cfg: dict, options: dict, ckpt: str, device):
        self.model_cfg = model_config(cfg, device)
        call_cfg = CallConfig(
            device_batch=int(options.get("device_batch")
                             or CallConfig.device_batch),
            transfer_dtype=options.get("transfer_dtype", "float16"),
            num_parse_workers=options.get("parse_workers"),
            device_resident=options.get("device_resident", "never"))
        self.engine = CallModsEngine(ckpt, self.model_cfg, call_cfg, [device])

    @property
    def compute_dtype(self) -> str:
        return self.model_cfg.compute_dtype

    def run_pass(self, input_path: str, out_path: str) -> dict:
        """One pass; the engine's CallStats as a dict."""
        return dataclasses.asdict(
            self.engine.run_features_file(input_path, out_path))

    def close(self) -> None:
        self.engine = None


def build(cfg: dict, options: dict, ckpt: str, device) -> Entry:
    return Entry(cfg, options, ckpt, device)
