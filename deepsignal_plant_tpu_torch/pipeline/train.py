"""train on a features TSV, on one device (counterpart of the
single-device branches of deepsignal_plant_tpu/pipeline/train.py:39-68,
:673-722, :746-799 and :802-1435).

Reference behavior (train.py:22-191): two datasets, one of four
optimizers, StepLR(step=2, gamma=.1), weighted CE with pos_weight,
gradient clip 0.5, a full validation every ``step_interval`` steps, a
checkpoint on an epoch-best accuracy within 2e-4 of the global best, and
an early stop after ``min_epoch_num`` epochs without improvement.

Three data planes, as the JAX package picks them on one device:

- device-resident (``device_resident="auto"``, the default): both
  datasets are uploaded once and every step gathers its rows on the
  device by the epoch permutation;
- host-fed (``"never"``): every step gathers its rows on the host and
  uploads them;
- streamed (``--stream yes``, or ``auto`` on a file over 8 GB): the
  training file is read block by block each epoch
  (io/dataset.StreamingFeatureDataset) and every batch is uploaded; the
  validation set is host-fed.

A host ``numpy.random.default_rng(seed)`` draws the epoch permutations in
the JAX package's order, so batch order is the same in both packages and
on every plane. A step's dropout masks come from a generator seeded by
(seed + 1, global step), as JAX folds the step into its key, so the
planes draw the same masks. Losses stay on the device until an eval
boundary reads them. Batches are not padded: the tail step has fewer
rows, which gives the loss and gradients JAX's masked padded step gives.

After every epoch the loop saves a train state (parameters, optimizer
state, epoch, global step, best accuracy; ``{module}.train_state.npz``),
and ``--resume`` continues from it, or from one the JAX package wrote.
As in the JAX package, a resumed run starts its permutation generator
afresh: it gives the weights of JAX's resumed run, not those of a run
that never stopped. The spill plane (datasets over the resident budget)
and the sharded and multi-host planes are not ported yet.
"""
from __future__ import annotations

import collections
import io
import json
import os
import pickle
import re
import sys
import time

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, model_config_from_args
from ..io.dataset import FeatureDataset, StreamingFeatureDataset
from ..models.bilstm import Batch, ModelBiLSTM, init_params
from ..models.convert import (_flatten, _unflatten, load_any_checkpoint,
                              params_to_numpy, save_checkpoint)
from ..ops import fused_lstm, recurrence
from ..ops.optim import STATE_SLOTS, Optimizer, step_decay_schedule
from ..utils import metrics as M
from ..utils.device import resolve_device

#: with --stream auto, a training file over this size streams (JAX
#: train.py:763-774)
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


def step_generator(key: int, step: int, device) -> torch.Generator:
    """The dropout generator of one training step, seeded by (key, step)
    — the same masks for the same step on every data plane. The train
    loop's key is seed + 1, denoise's seed + 7, as the JAX package's
    PRNG keys."""
    state = np.random.SeedSequence([key, step]).generate_state(2)
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

    def __init__(self, ds: FeatureDataset, device: torch.device):
        self.ds, self.device = ds, device

    def batch(self, idx):
        return _upload(*self.ds.batch_at(idx), self.device)

    def epoch(self, rng: np.random.Generator, batch_size: int):
        """One epoch's (batch, labels), in the order of one permutation
        drawn from ``rng``."""
        perm = rng.permutation(len(self.ds))
        for lo in range(0, len(perm), batch_size):
            yield self.batch(perm[lo:lo + batch_size])


class Resident:
    """Device-resident plane (JAX train.py:921-925, :1285-1316): the
    dataset is uploaded once; batches are gathered on the device."""

    def __init__(self, ds: FeatureDataset, device: torch.device):
        self.data, self.labels = _upload(*ds.batch_at(slice(None)), device)
        self.device = device

    def batch(self, idx):
        return Batch(*(a[idx] for a in self.data)), self.labels[idx]

    def epoch(self, rng: np.random.Generator, batch_size: int):
        perm = torch.from_numpy(rng.permutation(len(self.labels))).to(
            self.device)
        for lo in range(0, len(perm), batch_size):
            yield self.batch(perm[lo:lo + batch_size])


class Streamed:
    """Streamed plane (JAX train.py:1234-1249): the training file is read
    block by block and every batch is uploaded."""

    def __init__(self, ds: StreamingFeatureDataset, device: torch.device):
        self.ds, self.device = ds, device

    def epoch(self, rng: np.random.Generator, batch_size: int):
        for batch, labels in self.ds.iter_batches(batch_size, True, rng):
            yield _upload(batch, labels, self.device)


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


# ---------------------------------------------------------------------------
# the train state of --resume (JAX train.py:698-722)

#: the header's ``format`` of the port's container
TRAIN_STATE_FORMAT = "deepsignal_plant_tpu_torch.train_state"

#: the optax state classes a JAX train state pickles, with their fields
#: (optax 0.2; LookaheadState is the JAX package's own); a field named
#: after an Optimizer slot (STATE_SLOTS) fills that slot
_OPTAX_STATES = {
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByRmsState": ("nu",),
    "ScaleByScheduleState": ("count",),
    "TraceState": ("trace",),
    "EmptyState": (),
    "LookaheadState": ("slow", "step"),
}
_OPTAX_TUPLES = {name: collections.namedtuple(name, fields)
                 for name, fields in _OPTAX_STATES.items()}
#: numpy's array and scalar reconstructors (JAX's state holds arrays and
#: a float64 best accuracy), in numpy 1's and numpy 2's modules
_NUMPY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (f"numpy.{core}.multiarray", name) for core in ("core", "_core")
    for name in ("_reconstruct", "scalar")}


def train_state_path(model_dir: str, module: str) -> str:
    """The JAX package's name of the train state."""
    return os.path.join(model_dir, f"{module}.train_state.npz")


def save_train_state(path: str, model: ModelBiLSTM, opt: Optimizer,
                     epoch: int, global_step: int,
                     best_accuracy: float) -> None:
    """The port's container: plain npz arrays (``params/<name>``,
    ``opt/count``, ``opt/<slot>/<name>``, with the parameter names of
    the JAX layout) and a JSON ``header``; no pickle. Written to a
    temporary file and renamed, so a crash leaves the last state."""
    names = [k.replace(".", "/") for k, _ in model.named_parameters()]
    arrays = {"params/" + k: v
              for k, v in _flatten(params_to_numpy(model)).items()}
    for slot, leaves in opt.state_arrays().items():
        if slot == "count":
            arrays["opt/count"] = leaves
        else:
            arrays.update({f"opt/{slot}/{n}": a
                           for n, a in zip(names, leaves)})
    header = {"format": TRAIN_STATE_FORMAT,
              "optim_type": opt.optim_type, "epoch": epoch,
              "global_step": global_step, "best_accuracy": best_accuracy}
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    tmp = path[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


class _TrainStateUnpickler(pickle.Unpickler):
    """Unpickles a JAX train state: numpy's array reconstructors, and the
    optax state classes as namedtuples of the port's; any other global
    raises."""

    def find_class(self, module: str, name: str):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if name in _OPTAX_TUPLES and (
                module.split(".")[0] == "optax"
                or module == "deepsignal_plant_tpu.ops.optim"):
            return _OPTAX_TUPLES[name]
        raise pickle.UnpicklingError(
            f"a train state may not name {module}.{name}")


def _optax_slots(opt_state) -> tuple[str, dict]:
    """(optim_type, {"count": n, slot: {name: array}}) of a JAX
    optimizer state (the tuple make_optimizer's transforms pickle)."""
    found: dict = {}
    kinds: set = set()

    def walk(node):
        if type(node) in _OPTAX_TUPLES.values():
            kinds.add(type(node).__name__)
            for field, value in zip(node._fields, node):
                found.setdefault(field, value)
        elif isinstance(node, tuple):
            for x in node:
                walk(x)
        else:
            raise ValueError(f"unexpected {type(node).__name__} in a JAX "
                             "optimizer state")

    walk(opt_state)
    optim_type = ("Ranger" if "LookaheadState" in kinds else
                  "Adam" if "ScaleByAdamState" in kinds else
                  "RMSprop" if "ScaleByRmsState" in kinds else
                  "SGD" if "TraceState" in kinds else None)
    if optim_type is None or "count" not in found:
        raise ValueError(f"unknown JAX optimizer state {sorted(kinds)}")
    out = {"count": int(np.asarray(found["count"]))}
    for slot in STATE_SLOTS[optim_type]:
        out[slot] = _flatten(found[slot])
    return optim_type, out


def load_train_state(path: str) -> dict:
    """A train state written by the port or by the JAX package: {params
    (the JAX layout), opt ({"count": n, slot: {name: array}}),
    optim_type, epoch, global_step, best_accuracy}. The JAX package's
    container (a pickled dict in ``train_state``) is read through an
    unpickler that admits numpy arrays and optax states only."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if "train_state" in arrays:
        st = _TrainStateUnpickler(
            io.BytesIO(arrays["train_state"].tobytes())).load()
        optim_type, opt = _optax_slots(st["opt_state"])
        return {"params": st["params"], "opt": opt,
                "optim_type": optim_type, "epoch": int(st["epoch"]),
                "global_step": int(st["global_step"]),
                "best_accuracy": float(st["best_accuracy"])}
    header = json.loads(arrays.pop("header").tobytes().decode())
    if header.get("format") != TRAIN_STATE_FORMAT:
        raise ValueError(f"{path} is no train state")
    opt: dict = {"count": int(arrays.pop("opt/count"))}
    params = {}
    for k, v in arrays.items():
        kind, rest = k.split("/", 1)
        if kind == "params":
            params[rest] = v
        else:
            slot, name = rest.split("/", 1)
            opt.setdefault(slot, {})[name] = v
    return {"params": _unflatten(params), "opt": opt,
            "optim_type": header["optim_type"], "epoch": header["epoch"],
            "global_step": header["global_step"],
            "best_accuracy": header["best_accuracy"]}


def restore_optimizer(opt: Optimizer, model: ModelBiLSTM, st: dict,
                       path: str) -> None:
    """Load a train state's optimizer arrays into ``opt``, by parameter
    name."""
    if st["optim_type"] != opt.optim_type:
        raise ValueError(f"{path} holds {st['optim_type']} state; this run "
                         f"trains with {opt.optim_type}")
    names = [k.replace(".", "/") for k, _ in model.named_parameters()]
    state = {"count": st["opt"]["count"]}
    for slot in STATE_SLOTS[opt.optim_type]:
        leaves = st["opt"].get(slot, {})
        if set(leaves) != set(names):
            raise ValueError(f"{path}: the {slot} state does not match the "
                             "model's parameters")
        state[slot] = [leaves[n] for n in names]
    opt.load_state_arrays(state)


def sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(model_cfg: ModelConfig, train_cfg: TrainConfig,
               train_ds: FeatureDataset | StreamingFeatureDataset,
               valid_ds: FeatureDataset, model_dir: str | None,
               device: torch.device, init_model: str | None = None,
               verbose: bool = True, resume: bool = False) -> dict:
    """The training loop on one device (JAX train.py:802-1435, its
    single-device host-fed, resident and streaming branches). With a
    ``model_dir`` it saves the train state after every epoch, and with
    ``resume`` it continues from that file when it exists. Returns the
    best accuracy and checkpoint, the final parameters (numpy pytree),
    the steps' losses and the validation accuracies of this run, and its
    counters."""
    t_start = time.time()
    if train_cfg.device_resident not in ("auto", "never"):
        raise ValueError("device_resident must be auto|never")
    streamed = isinstance(train_ds, StreamingFeatureDataset)
    resident = train_cfg.device_resident == "auto" and not streamed
    if resident and train_ds.nbytes + valid_ds.nbytes > resident_budget(
            device):
        raise ValueError(
            "the datasets ({} bytes) exceed the device-resident budget; "
            "the JAX package's spill plane for them is "
            "not yet ported to deepsignal_plant_tpu_torch: pass "
            "--device_resident never for the host-fed plane".format(
                train_ds.nbytes + valid_ds.nbytes))
    if streamed:
        train_src = Streamed(train_ds, device)
        valid_src = HostFed(valid_ds, device)
    else:
        plane = Resident if resident else HostFed
        train_src, valid_src = plane(train_ds, device), plane(valid_ds,
                                                              device)
    if verbose and resident:
        print("device-resident data plane: {} train + {} valid rows on "
              "{}".format(len(train_ds), len(valid_ds), device))

    rng_np = np.random.default_rng(train_cfg.seed)
    params = init_params(model_cfg, train_cfg.seed)
    if init_model is not None:
        print(f"loading pre-trained model: {init_model}")
        params = load_any_checkpoint(init_model, model_cfg)
    state_path = (train_state_path(model_dir, model_cfg.module)
                  if model_dir is not None else None)
    st = (load_train_state(state_path)
          if resume and state_path is not None
          and os.path.exists(state_path) else None)
    if st is not None:
        params = st["params"]
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
    global_step = start_epoch = 0
    if st is not None:
        restore_optimizer(opt, model, st, state_path)
        start_epoch, global_step = st["epoch"], st["global_step"]
        best_accuracy = st["best_accuracy"]
        if verbose:
            print("resuming training from epoch {} (step {})".format(
                start_epoch, global_step))
    start_step = global_step
    epochs_run = start_epoch
    step_losses: list[float] = []
    valid_accuracies: list[float] = []
    epoch_seconds: list[float] = []
    counters = {"train_seconds": 0.0, "eval_seconds": 0.0, "eval_tiles": 0,
                "train_rows": 0, "epoch_train_seconds": []}
    for epoch in range(start_epoch, train_cfg.max_epoch_num):
        counters["epoch_train_seconds"].append(0.0)
        epoch_best = 0.0
        no_best_model = True
        tlosses: list[torch.Tensor] = []
        tic = epoch_t0 = t_interval = time.time()

        def eval_boundary(step_in_epoch: int):
            """Eval + best checkpoint + log (JAX train.py:1250-1283)."""
            nonlocal best_accuracy, epoch_best, no_best_model, best_ckpt
            nonlocal tlosses, tic, t_interval
            sync_device(device)
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

        for i, (batch, labels) in enumerate(train_src.epoch(rng_np, B)):
            gen = (step_generator(train_cfg.seed + 1, global_step, device)
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
        if state_path is not None:
            save_train_state(state_path, model, opt, epoch + 1, global_step,
                             best_accuracy)
        if no_best_model and epoch >= train_cfg.min_epoch_num - 1:
            if verbose:
                print("early stop!")
            break

    if verbose:
        print("[main] train costs {:.1f} seconds, best accuracy: {}".format(
            time.time() - t_start, best_accuracy))
    plane_name = ("stream" if streamed else
                  "resident" if resident else "host-fed")
    return {"best_accuracy": best_accuracy, "best_ckpt": best_ckpt,
            "epochs_run": epochs_run, "params": params_to_numpy(model),
            "steps": global_step, "start_epoch": start_epoch,
            "start_step": start_step, "step_losses": step_losses,
            "valid_accuracies": valid_accuracies,
            "epoch_seconds": epoch_seconds, "resident": resident,
            "plane": plane_name, **counters}


def kernel_launches() -> dict:
    return {**fused_lstm.launches, **recurrence.launches}


def kernel_launches_since(before: dict) -> dict:
    """Launches of every kernel counter since the ``before`` snapshot
    (``kernel_launches()``)."""
    return {k: v - before[k] for k, v in kernel_launches().items()}


def use_stream(args) -> bool:
    """--stream yes, or auto on a training file over STREAM_MIN_BYTES
    (JAX train.py:763-774)."""
    return args.stream == "yes" or (
        args.stream == "auto"
        and os.path.getsize(args.train_file) > STREAM_MIN_BYTES)


def train(args) -> dict:
    """CLI entry mirroring reference train(args) (train.py:22). Returns
    train_loop's summary."""
    for path in (args.train_file, args.valid_file):
        if not os.path.exists(path):
            raise ValueError(f"{path} does not exist!")
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
    if use_stream(args):
        print("using streaming (block-shuffled) training dataset..")
        train_ds = StreamingFeatureDataset(
            args.train_file, model_cfg.seq_len, model_cfg.signal_len)
    else:
        train_ds = FeatureDataset.from_file(
            args.train_file, model_cfg.seq_len, model_cfg.signal_len)
    valid_ds = FeatureDataset.from_file(args.valid_file, model_cfg.seq_len,
                                        model_cfg.signal_len)
    read_seconds = time.time() - t0

    model_dir = args.model_dir
    if model_dir != "/":
        model_dir = os.path.abspath(model_dir).rstrip("/")
        os.makedirs(model_dir, exist_ok=True)
        if not args.resume:
            clean_old_ckpts(model_dir, model_cfg.module)
    model_dir += "/"

    launches0 = kernel_launches()
    res = train_loop(model_cfg, train_cfg, train_ds, valid_ds, model_dir,
                     device, init_model=args.init_model, resume=args.resume)
    if args.verbose_stages:
        print("[stages] " + json.dumps({
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "compute_dtype": model_cfg.compute_dtype,
            "recurrence": model_cfg.recurrence,
            "plane": res["plane"],
            "start_epoch": res["start_epoch"],
            "start_step": res["start_step"],
            "epochs_run": res["epochs_run"],
            "steps": res["steps"], "train_rows": res["train_rows"],
            "eval_tiles": res["eval_tiles"],
            "kernel_launches": kernel_launches_since(launches0),
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
