"""train on a features TSV, on one device (counterpart of the
single-device branches of deepsignal_plant_tpu/pipeline/train.py:39-68,
:673-695, :720-744, :746-799 and :802-1435).

Reference behavior (train.py:22-191): two datasets, one of four
optimizers, StepLR(step=2, gamma=.1), weighted CE with pos_weight,
gradient clip 0.5, a full validation every ``step_interval`` steps, a
checkpoint on an epoch-best accuracy within 2e-4 of the global best, and
an early stop after ``min_epoch_num`` epochs without improvement.

Two data planes, as the JAX package picks them on one device:

- device-resident (``device_resident="auto"``, the default): both
  datasets are uploaded once and every step gathers its rows on the
  device by the epoch permutation;
- host-fed (``"never"``): every step gathers its rows on the host and
  uploads them.

A host ``numpy.random.default_rng(seed)`` draws the epoch permutations in
the JAX package's order, so batch order is the same in both packages and
both planes. A step's dropout masks come from a generator seeded by
(seed + 1, global step), as JAX folds the step into its key, so both
planes draw the same masks. Losses stay on the device until an eval
boundary reads them. Batches are not padded: the tail step has fewer
rows, which gives the loss and gradients JAX's masked padded step gives.
The spill plane (a dataset over the resident budget), the sharded and
multi-host planes, streaming and ``--resume`` are not ported yet.
"""
from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, model_config_from_args
from ..io.dataset import FeatureDataset
from ..models.bilstm import Batch, ModelBiLSTM, init_params
from ..models.convert import (load_any_checkpoint, params_to_numpy,
                              save_checkpoint)
from ..ops import fused_lstm, recurrence
from ..ops.optim import Optimizer, step_decay_schedule
from ..utils import metrics as M
from ..utils.device import resolve_device

#: files this large would take the JAX package's streaming dataset
#: (train.py:763-774), which is not ported yet
STREAM_MIN_BYTES = 8 << 30


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                class_weights: torch.Tensor) -> torch.Tensor:
    """torch nn.CrossEntropyLoss(weight=w) semantics (reference
    train.py:78): sum(w[y] * ce) / sum(w[y]), in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    w = class_weights[labels]
    return (w * ce).sum() / torch.clamp(w.sum(), min=1e-12)


def clip_by_global_norm(grads: list, clip: float) -> list:
    """Scale by min(1, clip / max(||g||, 1e-12)) over all leaves (JAX
    train.py:62-66); torch's clip_grad_norm_ divides by ||g|| + 1e-6
    instead."""
    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    return [g * scale for g in grads]


def train_step(model: ModelBiLSTM, weights: list, opt: Optimizer,
               batch: Batch, labels: torch.Tensor,
               class_weights: torch.Tensor, clip: float,
               generator: torch.Generator | None) -> torch.Tensor:
    """One update (JAX make_train_step, single device): the training
    forward, the weighted CE, its gradients, the clip and the optimizer
    step. Returns the loss, left on the device."""
    logits, _ = model(batch, train=True, generator=generator)
    loss = weighted_ce(logits, labels, class_weights)
    grads = torch.autograd.grad(loss, weights)
    opt.step(clip_by_global_norm(grads, clip))
    return loss.detach()


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one training step, seeded by (seed + 1,
    step) — the same masks for the same step on either data plane."""
    state = np.random.SeedSequence([seed + 1, step]).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _upload(batch: Batch, labels: np.ndarray, device: torch.device):
    """Host arrays -> device tensors: base codes int32, features float32,
    labels int64 (the index type). From pinned memory on the card, so the
    copy does not wait for the device."""
    def up(a, dt):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return (Batch(up(batch.kmer, np.int32), up(batch.base_means, np.float32),
                  up(batch.base_stds, np.float32),
                  up(batch.base_signal_lens, np.float32),
                  up(batch.signals, np.float32)),
            up(labels, np.int64))


class HostFed:
    """Host-fed plane: each batch is gathered on the host and uploaded."""
    resident = False

    def __init__(self, ds: FeatureDataset, device: torch.device):
        self.ds, self.device = ds, device

    def order(self, perm: np.ndarray) -> np.ndarray:
        return perm

    def batch(self, idx):
        return _upload(*self.ds.batch_at(idx), self.device)


class Resident:
    """Device-resident plane (JAX train.py:921-925, :1285-1316): the
    dataset is uploaded once; batches are gathered on the device."""
    resident = True

    def __init__(self, ds: FeatureDataset, device: torch.device):
        self.data, self.labels = _upload(*ds.batch_at(slice(None)), device)
        self.device = device

    def order(self, perm: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(perm).to(self.device)

    def batch(self, idx):
        return Batch(*(a[idx] for a in self.data)), self.labels[idx]


def resident_budget(device: torch.device) -> int:
    """Bytes of datasets the resident plane may keep on the device: half
    of the card's free memory, leaving the rest to the model, its
    activations and the optimizer. The CPU holds them where they are."""
    if device.type != "cuda":
        return sys.maxsize
    free, _ = torch.cuda.mem_get_info(device)
    return free // 2


@torch.no_grad()
def evaluate(model: ModelBiLSTM, source, labels: np.ndarray,
             batch_size: int, class_weights: torch.Tensor) -> dict:
    """Validation metrics (JAX train.py:673-695): the weighted CE of each
    batch averaged over batches, accuracy, precision and recall. One
    inference forward per batch; one read of the results at the end."""
    preds, losses = [], []
    for lo in range(0, len(labels), batch_size):
        batch, y = source.batch(slice(lo, lo + batch_size))
        logits, probs = model(batch)
        preds.append(torch.argmax(probs, dim=1))
        losses.append(weighted_ce(logits, y, class_weights))
    pred = torch.cat(preds).cpu().numpy() if preds else np.empty(0, np.int64)
    loss = torch.stack(losses).cpu().numpy() if losses else np.zeros(1)
    return {"loss": float(np.mean(loss.astype(np.float64))),
            "accuracy": M.accuracy(labels, pred),
            "precision": M.precision(labels, pred),
            "recall": M.recall(labels, pred),
            "batches": len(losses)}


def ckpt_name(model_dir: str, module: str, seq_len: int, signal_len: int,
              epoch: int) -> str:
    """Reference naming (train.py:161-164), in the .npz container."""
    return os.path.join(
        model_dir, f"{module}.b{seq_len}_s{signal_len}_epoch{epoch}.ckpt.npz")


def clean_old_ckpts(model_dir: str, module: str) -> None:
    """Remove stale checkpoints of the same model type at train start
    (reference train.py:54-57)."""
    rx = re.compile(re.escape(module) + r"\.b\d+_s\d+_epoch\d+\.ckpt")
    for f in os.listdir(model_dir):
        if rx.match(f):
            try:
                os.remove(os.path.join(model_dir, f))
            except FileNotFoundError:
                pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(model_cfg: ModelConfig, train_cfg: TrainConfig,
               train_ds: FeatureDataset, valid_ds: FeatureDataset,
               model_dir: str | None, device: torch.device,
               init_model: str | None = None, verbose: bool = True) -> dict:
    """The training loop on one device (JAX train.py:802-1435, its
    single-device host-fed and resident branches). Returns the best
    accuracy and checkpoint, the final parameters (numpy pytree), every
    step's loss and every validation accuracy, and the run's counters."""
    t_start = time.time()
    if train_cfg.device_resident not in ("auto", "never"):
        raise ValueError("device_resident must be auto|never")
    resident = train_cfg.device_resident == "auto"
    if resident and train_ds.nbytes + valid_ds.nbytes > resident_budget(
            device):
        raise ValueError(
            "the datasets ({} bytes) exceed the device-resident budget, "
            "where the JAX package takes its spill plane, which is not yet "
            "ported to deepsignal_plant_tpu_torch; pass --device_resident "
            "never for the host-fed plane".format(
                train_ds.nbytes + valid_ds.nbytes))
    plane = Resident if resident else HostFed
    train_src, valid_src = plane(train_ds, device), plane(valid_ds, device)
    if verbose and resident:
        print("device-resident data plane: {} train + {} valid rows on "
              "{}".format(len(train_ds), len(valid_ds), device))

    rng_np = np.random.default_rng(train_cfg.seed)
    params = init_params(model_cfg, train_cfg.seed)
    if init_model is not None:
        print(f"loading pre-trained model: {init_model}")
        params = load_any_checkpoint(init_model, model_cfg)
    model = ModelBiLSTM.from_params(params, model_cfg, device, trainable=True)
    weights = list(model.parameters())

    B = train_cfg.batch_size
    steps_per_epoch = max(1, -(-len(train_ds) // B))
    opt = Optimizer(train_cfg.optim_type, step_decay_schedule(
        train_cfg.lr, steps_per_epoch, train_cfg.lr_decay_step,
        train_cfg.lr_decay), weights)
    class_weights = torch.tensor([1.0, train_cfg.pos_weight],
                                 dtype=torch.float32, device=device)

    if verbose:
        print("total_step: {}".format(steps_per_epoch))
    best_accuracy = 0.0
    best_ckpt = None
    global_step = 0
    epochs_run = 0
    step_losses: list[float] = []
    valid_accuracies: list[float] = []
    epoch_seconds: list[float] = []
    counters = {"train_seconds": 0.0, "eval_seconds": 0.0, "eval_tiles": 0,
                "train_rows": 0, "epoch_train_seconds": []}
    for epoch in range(train_cfg.max_epoch_num):
        counters["epoch_train_seconds"].append(0.0)
        epoch_best = 0.0
        no_best_model = True
        tlosses: list[torch.Tensor] = []
        tic = epoch_t0 = t_interval = time.time()

        def eval_boundary(step_in_epoch: int):
            """Eval + best checkpoint + log (JAX train.py:1250-1283)."""
            nonlocal best_accuracy, epoch_best, no_best_model, best_ckpt
            nonlocal tlosses, tic, t_interval
            _sync(device)
            t_eval = time.time()
            counters["train_seconds"] += t_eval - t_interval
            counters["epoch_train_seconds"][-1] += t_eval - t_interval
            losses = torch.stack(tlosses).cpu().numpy().tolist()
            step_losses.extend(losses)
            stats = evaluate(model, valid_src, valid_ds.labels, B,
                             class_weights)
            counters["eval_tiles"] += stats["batches"]
            v_acc = stats["accuracy"]
            valid_accuracies.append(v_acc)
            if v_acc > epoch_best:
                epoch_best = v_acc
                if epoch_best > best_accuracy - 0.0002:
                    if model_dir is not None:
                        best_ckpt = ckpt_name(model_dir, model_cfg.module,
                                              model_cfg.seq_len,
                                              model_cfg.signal_len,
                                              epoch + 1)
                        save_checkpoint(best_ckpt, params_to_numpy(model),
                                        model_cfg)
                    if epoch_best > best_accuracy:
                        best_accuracy = epoch_best
                        no_best_model = False
            if verbose:
                print("Epoch [{}/{}], Step [{}/{}], TrainLoss: {:.4f}; "
                      "ValidLoss: {:.4f}, Accuracy: {:.4f}, "
                      "Precision: {:.4f}, Recall: {:.4f}, "
                      "curr_epoch_best_accuracy: {:.4f}; Time: {:.2f}s"
                      .format(epoch + 1, train_cfg.max_epoch_num,
                              step_in_epoch, steps_per_epoch,
                              float(np.mean(losses)), stats["loss"], v_acc,
                              stats["precision"], stats["recall"],
                              epoch_best, time.time() - tic))
                sys.stdout.flush()
            tlosses = []
            tic = t_interval = time.time()
            counters["eval_seconds"] += t_interval - t_eval

        order = train_src.order(rng_np.permutation(len(train_ds)))
        for i in range(steps_per_epoch):
            batch, labels = train_src.batch(order[i * B:(i + 1) * B])
            gen = (step_generator(train_cfg.seed, global_step, device)
                   if model_cfg.dropout_rate > 0 else None)
            tlosses.append(train_step(model, weights, opt, batch, labels,
                                      class_weights, train_cfg.clip_grad,
                                      gen))
            counters["train_rows"] += len(labels)
            global_step += 1
            if (i + 1) % train_cfg.step_interval == 0 \
                    or (i + 1) == steps_per_epoch:
                eval_boundary(i + 1)
        epochs_run = epoch + 1
        epoch_seconds.append(time.time() - epoch_t0)
        if no_best_model and epoch >= train_cfg.min_epoch_num - 1:
            if verbose:
                print("early stop!")
            break

    if verbose:
        print("[main] train costs {:.1f} seconds, best accuracy: {}".format(
            time.time() - t_start, best_accuracy))
    return {"best_accuracy": best_accuracy, "best_ckpt": best_ckpt,
            "epochs_run": epochs_run, "params": params_to_numpy(model),
            "steps": global_step, "step_losses": step_losses,
            "valid_accuracies": valid_accuracies,
            "epoch_seconds": epoch_seconds, "resident": resident,
            **counters}


def _refuse_unported(args) -> None:
    """Planes of the JAX train that this package does not have yet fail
    here, before any work, instead of running something else."""
    big = os.path.getsize(args.train_file) > STREAM_MIN_BYTES
    refused = [
        (args.resume, "--resume"),
        (args.stream == "yes" or (args.stream == "auto" and big),
         "the streaming training dataset (--stream yes, or auto on a file "
         "over 8 GB)"),
    ]
    for hit, what in refused:
        if hit:
            raise ValueError(
                f"{what} is not yet ported to deepsignal_plant_tpu_torch "
                "(the JAX package deepsignal_plant_tpu serves it)")


def _kernel_launches() -> dict:
    return {**fused_lstm.launches, **recurrence.launches}


def train(args) -> dict:
    """CLI entry mirroring reference train(args) (train.py:22). Returns
    train_loop's summary."""
    for path in (args.train_file, args.valid_file):
        if not os.path.exists(path):
            raise ValueError(f"{path} does not exist!")
    _refuse_unported(args)
    device = resolve_device(args.device)
    print("[main] train starts..")
    model_cfg = model_config_from_args(args, device, args.dropout_rate)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, lr=args.lr, lr_decay=args.lr_decay,
        lr_decay_step=args.lr_decay_step, max_epoch_num=args.max_epoch_num,
        min_epoch_num=args.min_epoch_num, step_interval=args.step_interval,
        pos_weight=args.pos_weight, optim_type=args.optim_type,
        device_resident=args.device_resident)

    print("reading data..")
    t0 = time.time()
    train_ds = FeatureDataset.from_file(args.train_file, model_cfg.seq_len,
                                        model_cfg.signal_len)
    valid_ds = FeatureDataset.from_file(args.valid_file, model_cfg.seq_len,
                                        model_cfg.signal_len)
    read_seconds = time.time() - t0

    model_dir = args.model_dir
    if model_dir != "/":
        model_dir = os.path.abspath(model_dir).rstrip("/")
        os.makedirs(model_dir, exist_ok=True)
        clean_old_ckpts(model_dir, model_cfg.module)
    model_dir += "/"

    launches0 = _kernel_launches()
    res = train_loop(model_cfg, train_cfg, train_ds, valid_ds, model_dir,
                     device, init_model=args.init_model)
    if args.verbose_stages:
        print("[stages] " + json.dumps({
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "compute_dtype": model_cfg.compute_dtype,
            "recurrence": model_cfg.recurrence,
            "plane": "resident" if res["resident"] else "host-fed",
            "steps": res["steps"], "train_rows": res["train_rows"],
            "eval_tiles": res["eval_tiles"],
            "kernel_launches": {k: v - launches0[k]
                                for k, v in _kernel_launches().items()},
            "read_seconds": read_seconds,
            "train_seconds": res["train_seconds"],
            "eval_seconds": res["eval_seconds"],
            "epoch_train_seconds": res["epoch_train_seconds"],
            "samples_per_s": (res["train_rows"] / res["train_seconds"]
                              if res["train_seconds"] else 0.0),
            "valid_accuracies": res["valid_accuracies"],
            "step_losses": res["step_losses"],
            "best_accuracy": res["best_accuracy"],
            "best_ckpt": res["best_ckpt"]}))
    return res
