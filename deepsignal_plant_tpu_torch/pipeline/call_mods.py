"""call_mods on a features TSV (counterpart of the per-site TSV plane of
deepsignal_plant_tpu/pipeline/call_mods.py:106-144, :380-430, :528-553,
:1803-1918 and :1921-1967).

Reference behavior (call_modifications.py:532-640): read 12-column
feature rows, run ModelBiLSTM, emit 10-column call rows.

    parse thread -> bounded prefetch -> upload + tiled forward (card)
                                     -> format (main thread) -> writer thread

Each block of ``device_batch`` rows is cast to the wire dtype on the
host, uploaded, upcast on the device and run in COMPUTE_TILE-row forward
tiles. There is no fallback: on the card the forward runs the layer
kernel, or the run fails.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import CallConfig, ModelConfig, model_config_from_args
from ..io.batching import AsyncWriter, PrefetchIterator, iter_line_blocks
from ..models.bilstm import Batch, ModelBiLSTM
from ..models.convert import load_any_checkpoint
from ..ops import fused_lstm
from ..utils.device import resolve_device
from ..utils.formats import format_call_rows, parse_feature_lines

#: forward tile: wider batches run the forward in COMPUTE_TILE-row tiles
#: and the ragged tail as one narrow forward, so every row sees the
#: numerics of a forward no wider than this (the JAX package measured
#: bf16 call flips in 16384-wide forwards and none at 4096)
COMPUTE_TILE = 4096


def forward_tiled(model: ModelBiLSTM, b: Batch) -> torch.Tensor:
    """Inference probabilities (N, num_classes) in <= COMPUTE_TILE-row
    forwards; ceil(N / COMPUTE_TILE) of them."""
    n = b.kmer.shape[0]
    probs = [model(Batch(*(a[lo:lo + COMPUTE_TILE] for a in b)))[1]
             for lo in range(0, n, COMPUTE_TILE)]
    return probs[0] if len(probs) == 1 else torch.cat(probs)


@dataclass
class CallStats:
    sites: int = 0
    batches: int = 0
    forward_tiles: int = 0
    seconds: float = 0.0
    # main-thread time in upload + forward + readback, and in formatting
    device_seconds: float = 0.0
    format_seconds: float = 0.0
    # called labels matching the features' label column — meaningful only
    # on labeled features (call_modifications.py:171-173)
    label_correct: int = 0

    @property
    def sites_per_s(self) -> float:
        return self.sites / self.seconds if self.seconds else 0.0

    @property
    def label_accuracy(self) -> float:
        return self.label_correct / self.sites if self.sites else 0.0


class CallModsEngine:
    """Loads a checkpoint once onto ``device`` and calls feature files."""

    def __init__(self, model_path: str, model_cfg: ModelConfig,
                 call_cfg: CallConfig | None = None,
                 device: torch.device | str | None = None):
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        self.model_cfg = model_cfg
        self.call_cfg = call_cfg or CallConfig()
        self.model = ModelBiLSTM.from_params(
            load_any_checkpoint(model_path, self.model_cfg), self.model_cfg,
            self.device)

    def to_device(self, fb) -> Batch:
        """Cast a FeatureBatch to the wire dtype on the host, upload it and
        upcast to float32 on the device (the model casts on to its compute
        dtype). Base codes travel as int8."""
        wire = np.dtype(self.call_cfg.transfer_dtype)

        def up(a: np.ndarray, dt) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(
                self.device)

        return Batch(kmer=up(fb.kmer, np.int8),
                     base_means=up(fb.base_means, wire).float(),
                     base_stds=up(fb.base_stds, wire).float(),
                     base_signal_lens=up(fb.base_signal_lens, wire).float(),
                     signals=up(fb.signals, wire).float())

    def predict_probs(self, fb) -> np.ndarray:
        """One FeatureBatch -> (N, num_classes) float32 probabilities."""
        with torch.inference_mode():
            return forward_tiled(self.model, self.to_device(fb)).cpu().numpy()

    def run_features_file(self, input_path: str, result_path: str,
                          is_gzip: bool = False) -> CallStats:
        """features TSV -> call_mods TSV (reference else-branch,
        call_modifications.py:584-636)."""
        cfg = self.model_cfg
        stats = CallStats()
        t0 = time.time()
        blocks = PrefetchIterator(
            (parse_feature_lines(lines, cfg.seq_len, cfg.signal_len)
             for lines in iter_line_blocks(input_path,
                                           self.call_cfg.device_batch)),
            depth=4)
        writer = AsyncWriter(result_path, is_gzip)
        try:
            for fb in blocks:
                t1 = time.time()
                probs = self.predict_probs(fb)
                t2 = time.time()
                writer.write_rows(format_call_rows(
                    fb.sampleinfo, fb.kmer, probs[:, 0], probs[:, 1]))
                stats.device_seconds += t2 - t1
                stats.format_seconds += time.time() - t2
                n = len(fb)
                stats.sites += n
                stats.batches += 1
                stats.forward_tiles += -(-n // COMPUTE_TILE)
                called = probs[:, 1] > probs[:, 0]
                stats.label_correct += int((called == (fb.labels == 1)).sum())
        finally:
            writer.close()
        stats.seconds = time.time() - t0
        return stats


def _refuse_unported(args, input_path: str) -> None:
    """Planes of the JAX call_mods that this package does not have yet
    fail here, before any work, instead of running something else."""
    refused = [
        (args.transfer_dtype == "int8", "--transfer_dtype int8"),
        (args.device_resident == "always", "--device_resident always"),
        (args.packed_wire == "force", "--packed_wire force"),
        (args.profile_dir is not None, "--profile_dir"),
        (input_path.endswith(".npz"), ".npz feature inputs"),
        (os.path.isdir(input_path),
         "directory inputs (fast5 runs or .npz batches)"),
    ]
    for hit, what in refused:
        if hit:
            raise ValueError(
                f"{what} is not yet ported to deepsignal_plant_tpu_torch "
                "(the JAX package deepsignal_plant_tpu serves it)")


def call_mods(args) -> CallStats:
    """CLI entry: mirrors reference call_mods(args)
    (call_modifications.py:532)."""
    input_path = os.path.abspath(args.input_path)
    if not os.path.exists(input_path):
        raise ValueError("--input_path does not exist!")
    model_path = os.path.abspath(args.model_path)
    if not os.path.exists(model_path):
        raise ValueError("--model_path is not set right!")
    _refuse_unported(args, input_path)
    device = resolve_device(args.device)
    model_cfg = model_config_from_args(args, device, args.dropout_rate)
    call_cfg = CallConfig(
        device_batch=args.device_batch or CallConfig.device_batch,
        transfer_dtype=("float16" if args.transfer_dtype == "auto"
                        else args.transfer_dtype))

    print("[main] call_mods starts..")
    t0 = time.time()
    launches0 = dict(fused_lstm.launches)
    engine = CallModsEngine(model_path, model_cfg, call_cfg, device)
    stats = engine.run_features_file(input_path, args.result_file,
                                     args.gzip)
    if args.verbose_stages:
        print("[stages] " + json.dumps({
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "compute_dtype": model_cfg.compute_dtype,
            "recurrence": model_cfg.recurrence,
            "transfer_dtype": call_cfg.transfer_dtype,
            "sites": stats.sites, "batches": stats.batches,
            "forward_tiles": stats.forward_tiles,
            "kernel_launches": {k: v - launches0[k]
                                for k, v in fused_lstm.launches.items()},
            "seconds": stats.seconds,
            "device_seconds": stats.device_seconds,
            "format_seconds": stats.format_seconds}))
    print("[main] call_mods costs %.2f seconds.. "
          "(%d sites, %.0f sites/s)" % (time.time() - t0, stats.sites,
                                        stats.sites_per_s))
    if stats.sites:
        print("[main] accuracy vs label column: %.4f "
              "(meaningful only on labeled features)" %
              stats.label_accuracy)
    return stats
