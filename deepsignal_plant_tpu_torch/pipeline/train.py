"""train on a features TSV, on one card or on many (counterpart of
deepsignal_plant_tpu/pipeline/train.py:39-127, :320-335, :574-622,
:673-722 and :746-1435).

Reference behavior (train.py:22-191): two datasets, one of four
optimizers, StepLR(step=2, gamma=.1), weighted CE with pos_weight,
gradient clip 0.5, a full validation every ``step_interval`` steps, a
checkpoint on an epoch-best accuracy within 2e-4 of the global best, and
an early stop after ``min_epoch_num`` epochs without improvement.

Data planes, as the JAX package picks them:

- device-resident (``device_resident="auto"``, the default): both
  datasets are uploaded once and every step gathers its rows on the
  device by the epoch permutation;
- spill (``auto`` on one card when the datasets exceed the resident
  budget but the validation set fits a quarter of it): the training set
  goes up slab by slab in float16 or int8, the next slab on a copy
  stream while the current one trains; two-level shuffle (slab order,
  then rows within a slab);
- host-fed (``"never"``, or datasets too big for both): every step
  gathers its rows on the host and uploads them;
- streamed (``--stream yes``, or ``auto`` on a file over 8 GB): the
  training file is read block by block each epoch
  (io/dataset.StreamingFeatureDataset) and every batch is uploaded; the
  validation set is host-fed.

Under a multi-process launch (WORLD_SIZE > 1; parallel/dist.py) rank r
is device r of JAX's data-parallel axis: the global batch is rounded up
to a multiple of the world size and each rank takes its share
(``local_B``) for ``ceil(ceil(N / world) / local_B)`` steps an epoch.
The resident plane becomes the sharded one (``Sharded``: contiguous
row blocks, every rank drawing every rank's block permutation from the
one seeded stream) and the host-fed plane takes a strided row shard
(``ShardedHostFed``: each rank permutes its own shard). Short and empty
steps are padded with row 0 and masked, so every rank runs the same
collectives. A multi-rank denoise also trains on the global-batch plane
(``GlobalBatch``: every rank holds the whole dataset and takes its share
of each batch of the one epoch permutation, JAX's one process over N
devices). A step sums the weighted-CE denominator over ranks before
the backward, back-propagates its numerator over that sum, sums the
gradients and the loss over ranks, and every rank applies the same
clipped update: the parameters stay bitwise equal across ranks.
Evaluation sums the loss terms and the prediction counts. Only rank 0
writes checkpoints, the train state and the log lines; ``--resume``
reads the state on rank 0 and broadcasts it. A streaming dataset under
a launch raises, as in the JAX package.

One process over N local cards (``train_loop`` given N devices; the CLI's
default ``--device`` outside a launch, utils/device.resolve_devices) is
JAX's one process over an N-device mesh: a model replica a card
(``Replica``), replica i in the place of device i. The global batch is
rounded up to a multiple of N and each replica takes its contiguous
share of every step (parallel/mesh.py), padded with row 0 and masked at
the epoch's tail. Data that fits takes the sharded-resident plane at
world N (``Replicated`` over ``Sharded``: each card its block, the block
permutations drawn once for all); otherwise, as JAX's host loop, one
permutation an epoch in the global-batch layout (``Replicated`` over
``GlobalBatch``), and a streamed file's padded batches cut into shares
(``StreamedShares``). There is no spill plane over several cards: data
over the budget goes host-fed, as in JAX. ``train_step`` runs every
replica's forward, sums the weight sums, runs every backward, sums the
gradients and losses in replica order on replica 0's card
(``replica_sum``) and gives every replica the same bytes, so the
replicas' parameters stay bitwise equal. Every replica works on its
card's current stream: PyTorch orders a copy between cards against both
cards' current streams, so the sums need no events, and two replicas on
one card run in turn. Replica 0 writes the checkpoints and the train
state; ``--resume`` loads the state into every replica.

A host ``numpy.random.default_rng(seed)`` draws the permutations in the
JAX package's order, so batch order is the same in both packages. A
step's dropout masks come from a generator seeded by (seed + 1, global
step[, rank]), as JAX folds the step (and its axis index) into its key.
Losses stay on the device until an eval boundary reads them. On one
card batches are not padded: the tail step has fewer rows, which gives
the loss and gradients JAX's masked padded step gives.

After every epoch the loop saves a train state (parameters, optimizer
state, epoch, global step, best accuracy; ``{module}.train_state.npz``),
and ``--resume`` continues from it, or from one the JAX package wrote.
As in the JAX package, a resumed run starts its permutation generator
afresh: it gives the weights of JAX's resumed run, not those of a run
that never stopped.
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, model_config_from_args
from ..io.dataset import FeatureDataset, StreamingFeatureDataset
from ..models.bilstm import Batch, ModelBiLSTM, init_params
from ..models.convert import (_flatten, _unflatten, load_any_checkpoint,
                              params_to_numpy, save_checkpoint)
from ..ops.fused_lstm import kernel_launches, kernel_launches_since
from ..ops.optim import STATE_SLOTS, Optimizer, step_decay_schedule
from ..parallel.dist import process_info
from ..parallel.mesh import local_batch_target, replica_sum, shares
from ..parallel.multihost import all_sum, broadcast_arrays, host_row_shard
from ..utils.device import resolve_devices

#: with --stream auto, a training file over this size streams (JAX
#: train.py:763-774)
STREAM_MIN_BYTES = 8 << 30


def masked_ce_terms(logits: torch.Tensor, labels: torch.Tensor,
                    class_weights: torch.Tensor,
                    mask: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of w[y] * ce, sum of w[y]) over the rows ``mask`` keeps (JAX
    train.py:39-50): the loss every plane shares; a multi-rank step sums
    both over ranks before dividing."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    w = class_weights[labels]
    if mask is not None:
        w = w * mask
    return (w * ce).sum(), w.sum()


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                class_weights: torch.Tensor) -> torch.Tensor:
    """torch nn.CrossEntropyLoss(weight=w) semantics (reference
    train.py:78): sum(w[y] * ce) / sum(w[y]), in float32."""
    num, den = masked_ce_terms(logits, labels, class_weights)
    return num / torch.clamp(den, min=1e-12)


def clip_by_global_norm(grads: list, clip: float) -> list:
    """Scale by min(1, clip / max(||g||, 1e-12)) over all leaves (JAX
    train.py:62-66); torch's clip_grad_norm_ divides by ||g|| + 1e-6
    instead."""
    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    return [g * scale for g in grads]


class Replica:
    """One model replica on one device: the trainable model, its
    parameters in order, its optimizer and the class weights of the
    loss."""

    def __init__(self, params, model_cfg: ModelConfig, device: torch.device,
                 optim_type: str, schedule, pos_weight: float):
        self.device = device
        self.model = ModelBiLSTM.from_params(params, model_cfg, device,
                                             trainable=True)
        self.weights = list(self.model.parameters())
        self.opt = Optimizer(optim_type, schedule, self.weights)
        self.class_weights = torch.tensor([1.0, pos_weight],
                                          dtype=torch.float32, device=device)


def reduce_replicas(per_replica: list[list[torch.Tensor]]
                    ) -> list[list[torch.Tensor]]:
    """JAX's ``psum`` over the data-parallel axis: the sums over a
    process's replicas (``replica_sum``), then over ranks (``all_sum``,
    this process's own without a process group); each replica's list of
    results, the same bytes on every replica and rank."""
    return [all_sum(ts) for ts in replica_sum(per_replica)]


def train_step(reps: list[Replica], parts, clip: float,
               gens: list) -> torch.Tensor:
    """One update (JAX make_train_step and its shard_map step,
    train.py:104-127) over a process's replicas. ``parts[i]``: replica
    i's (batch, labels, mask), the mask None for all rows; ``gens[i]``:
    its dropout generator or None. In phases: every replica's training
    forward and weighted-CE terms; the weight sums summed over replicas
    and ranks before the backward; every replica's gradients of its
    numerator over that sum; the gradients and losses summed (not
    averaged, as DDP would: the weight sums differ); the same clip and
    optimizer step on every replica, whose parameters stay bitwise
    equal. Returns the summed loss, left on replica 0's device."""
    terms = []
    for r, (batch, labels, mask), gen in zip(reps, parts, gens):
        logits, _ = r.model(batch, train=True, generator=gen)
        terms.append(masked_ce_terms(logits, labels, r.class_weights, mask))
    dens = reduce_replicas([[den] for _, den in terms])
    grads = []
    for r, (num, _), (den,) in zip(reps, terms, dens):
        loss = num / torch.clamp(den, min=1e-12)
        grads.append([*torch.autograd.grad(loss, r.weights), loss])
    summed = reduce_replicas(grads)
    for r, (*g, _) in zip(reps, summed):
        r.opt.step(clip_by_global_norm(g, clip))
    return summed[0][-1].detach()


def step_generator(key: int, step: int, device,
                   rank: int | None = None) -> torch.Generator:
    """The dropout generator of one training step, seeded by (key, step)
    — the same masks for the same step on every data plane — and, in a
    multi-rank run, by the rank, so ranks draw distinct masks (JAX folds
    in the axis index). The train loop's key is seed + 1, denoise's
    seed + 7, as the JAX package's PRNG keys."""
    entropy = [key, step] if rank is None else [key, step, rank]
    state = np.random.SeedSequence(entropy).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def replica_generators(key: int, step: int, reps: list,
                       rank: int, world: int) -> list[torch.Generator]:
    """Each replica's dropout generator of one step: device j of JAX's
    data-parallel axis is a launch's rank or a process's replica j (its
    axis index folded into the key), and one card without a launch folds
    none."""
    return [step_generator(key, step, r.device, rank if world > 1 else
                           j if len(reps) > 1 else None)
            for j, r in enumerate(reps)]


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


class Plane:
    """A data plane. ``epoch(rng, batch_size)`` yields one epoch's steps
    as (batch, labels, mask, rows): ``mask`` is None where every row
    counts (one card) and a float mask over padded rows otherwise;
    ``rows`` is the count of rows that count. ``eval_steps(batch_size)``
    yields the evaluation's steps as (batch, labels, mask).
    ``batch(idx)`` serves denoise's scoring."""

    def evaluates_after(self, step: int, steps: int, interval: int) -> bool:
        """Whether an evaluation follows the epoch's ``step``-th step:
        every ``interval`` steps and at the epoch's end (JAX
        train.py:1402-1404)."""
        return step % interval == 0 or step == steps

    def eval_steps(self, batch_size: int):
        """One card's evaluation: consecutive slices of ``batch_size``
        rows, the last one short, every row kept."""
        for lo in range(0, len(self), batch_size):
            yield (*self.batch(slice(lo, lo + batch_size)), None)

    def close(self) -> None:
        """Release what the plane holds beyond its tensors."""


class HostFed(Plane):
    """Host-fed plane: each batch is gathered on the host and uploaded."""

    def __init__(self, ds: FeatureDataset, device: torch.device):
        self.ds, self.device = ds, device

    def __len__(self) -> int:
        return len(self.ds)

    def batch(self, idx):
        return _upload(*self.ds.batch_at(idx), self.device)

    def epoch(self, rng: np.random.Generator, batch_size: int):
        """One epoch's steps, in the order of one permutation drawn from
        ``rng``."""
        perm = rng.permutation(len(self.ds))
        for lo in range(0, len(perm), batch_size):
            idx = perm[lo:lo + batch_size]
            yield (*self.batch(idx), None, len(idx))


class Resident(Plane):
    """Device-resident plane (JAX train.py:921-925, :1285-1316): the
    dataset is uploaded once; batches are gathered on the device."""

    def __init__(self, ds: FeatureDataset, device: torch.device):
        self.data, self.labels = _upload(*ds.batch_at(slice(None)), device)
        self.device = device

    def __len__(self) -> int:
        return len(self.labels)

    def batch(self, idx):
        return Batch(*(a[idx] for a in self.data)), self.labels[idx]

    def epoch(self, rng: np.random.Generator, batch_size: int):
        perm = torch.from_numpy(rng.permutation(len(self.labels))).to(
            self.device)
        for lo in range(0, len(perm), batch_size):
            idx = perm[lo:lo + batch_size]
            yield (*self.batch(idx), None, len(idx))


class Streamed(Plane):
    """Streamed plane (JAX train.py:1234-1249): the training file is read
    block by block and every batch is uploaded."""

    def __init__(self, ds: StreamingFeatureDataset, device: torch.device):
        self.ds, self.device = ds, device

    def epoch(self, rng: np.random.Generator, batch_size: int):
        for batch, labels in self.ds.iter_batches(batch_size, True, rng):
            yield (*_upload(batch, labels, self.device), None, len(labels))


def shard_rows(n: int, world: int) -> int:
    """The most rows a rank holds: ceil(n / world)."""
    return -(-n // world)


def _prefix_mask(n_valid: int, batch_size: int,
                 device: torch.device) -> torch.Tensor:
    """1.0 on the first ``n_valid`` of ``batch_size`` rows, 0.0 after."""
    return (torch.arange(batch_size, device=device)
            < n_valid).to(torch.float32)


class Sharded(Plane):
    """The sharded-resident plane of a multi-rank run (JAX
    train.py:574-622 and its scan chunks, :410-560, at ndev = world
    size): rank r keeps rows [r * R, (r + 1) * R) on its card, R =
    ceil(N / world), the last block padded with row 0 and masked by a
    row-valid vector. Every rank draws every rank's block permutation
    from the one seeded stream and keeps its own, zero-padded to
    ``steps * batch_size``; a step gathers ``batch_size`` rows of it."""

    def __init__(self, ds: FeatureDataset, device: torch.device, rank: int,
                 world: int, steps: int | None = None):
        n = len(ds)
        self.rows = shard_rows(n, world)
        lo = min(rank * self.rows, n)
        hi = min(lo + self.rows, n)
        idx = np.concatenate([np.arange(lo, hi),
                              np.zeros(self.rows - (hi - lo), np.int64)])
        self.valid_np = np.zeros(self.rows, np.float32)
        self.valid_np[:hi - lo] = 1.0
        self.data, self.labels = _upload(*ds.batch_at(idx), device)
        self.valid = torch.from_numpy(self.valid_np).to(device)
        self.device, self.rank, self.world, self.steps = (device, rank,
                                                          world, steps)

    def batch(self, idx):
        """Rows ``idx`` of this rank's block (local indices)."""
        return Batch(*(a[idx] for a in self.data)), self.labels[idx]

    def _step(self, idx: torch.Tensor, n_valid: int, batch_size: int):
        mask = _prefix_mask(n_valid, batch_size, self.device) \
            * self.valid[idx]
        return (*self.batch(idx), mask)

    def draw(self, rng: np.random.Generator, batch_size: int) -> list:
        """The epoch's block permutations, one a rank, from the one
        seeded stream."""
        return [rng.permutation(self.rows) for _ in range(self.world)]

    def epoch(self, rng: np.random.Generator, batch_size: int):
        yield from self.steps_of(self.draw(rng, batch_size), batch_size)

    def steps_of(self, perms: list, batch_size: int):
        """This rank's steps of the epoch ``draw`` drew: its block's
        permutation, zero-padded to ``steps * batch_size``."""
        width = self.steps * batch_size
        perm = np.concatenate([perms[self.rank], np.zeros(
            max(width - self.rows, 0), np.int64)])[:width]
        perm_t = torch.from_numpy(perm).to(self.device)
        for s in range(self.steps):
            lo = s * batch_size
            nv = min(max(self.rows - lo, 0), batch_size)
            rows = int(self.valid_np[perm[lo:lo + nv]].sum())
            yield (*self._step(perm_t[lo:lo + batch_size], nv, batch_size),
                   rows)

    def eval_steps(self, batch_size: int):
        """The evaluation's steps over this rank's block (JAX
        make_eval_chunk_sharded): ceil(R / batch_size) slices."""
        for s in range(max(1, -(-self.rows // batch_size))):
            lo = s * batch_size
            idx = torch.clamp(torch.arange(lo, lo + batch_size),
                              max=self.rows - 1).to(self.device)
            yield self._step(idx, min(max(self.rows - lo, 0), batch_size),
                             batch_size)


class ShardedHostFed(Plane):
    """The host-fed plane of a multi-rank run (JAX train.py:825-880,
    :1234-1246 with pcount = world size): rank r holds rows r, r + world,
    ... of the dataset, draws one permutation of them an epoch and runs
    ``steps`` steps; short and missing batches are padded with row 0
    and masked."""

    def __init__(self, ds: FeatureDataset, device: torch.device, rank: int,
                 world: int, steps: int | None = None):
        if len(ds) < world:
            raise ValueError(f"{len(ds)} rows cannot be shared out over "
                             f"{world} ranks")
        self.ds = ds.take(host_row_shard(len(ds), rank, world))
        self.n_global, self.world = len(ds), world
        self.device, self.steps = device, steps

    def _padded(self, batches, n_steps: int, batch_size: int):
        done = 0
        for batch, labels, nv in batches:
            done += 1
            yield (*_upload(batch, labels, self.device),
                   _prefix_mask(nv, batch_size, self.device), nv)
        for _ in range(done, n_steps):
            batch, labels = self.ds.batch_at(np.zeros(batch_size, np.int64))
            yield (*_upload(batch, labels, self.device),
                   _prefix_mask(0, batch_size, self.device), 0)

    def epoch(self, rng: np.random.Generator, batch_size: int):
        yield from self._padded(self.ds.iter_batches(
            batch_size, shuffle=True, rng=rng, pad_to_batch=True),
            self.steps, batch_size)

    def eval_steps(self, batch_size: int):
        """The evaluation's steps (JAX train.py:891-916): every rank runs
        ceil(ceil(N / world) / batch_size) of them."""
        steps = max(1, -(-shard_rows(self.n_global, self.world)
                         // batch_size))
        for batch, labels, mask, _ in self._padded(self.ds.iter_batches(
                batch_size, shuffle=False, pad_to_batch=True), steps,
                batch_size):
            yield batch, labels, mask


class GlobalBatch(Plane):
    """The global-batch plane of a multi-rank denoise (JAX
    denoise.py:166-221 on an N-device mesh): every rank holds the whole
    dataset, on its card when ``resident`` and on the host otherwise
    (the same numbers), and draws the one epoch permutation
    (``iter_batches``' order) from the shared seeded stream. A step
    takes the next ``world * batch_size`` rows of it, the tail padded
    with row 0, and rank r keeps rows [r * batch_size, (r + 1) *
    batch_size) of them, as shard_map's P("dp") splits a batch in
    device order; rows past the global batch's valid ones are masked,
    so a rank whose share is all padding still runs every
    collective."""

    def __init__(self, ds: FeatureDataset, device: torch.device, rank: int,
                 world: int, resident: bool):
        self.n, self.rank, self.world, self.device = (len(ds), rank, world,
                                                      device)
        if resident:
            self.ds = None
            self.data, self.labels = _upload(*ds.batch_at(slice(None)),
                                             device)
        else:
            self.ds = ds

    def batch(self, idx):
        """Rows ``idx`` (global indices: a slice, or an index array on
        the host plane and an index tensor on the resident one)."""
        if self.ds is not None:
            return _upload(*self.ds.batch_at(idx), self.device)
        return Batch(*(a[idx] for a in self.data)), self.labels[idx]

    def draw(self, rng: np.random.Generator, batch_size: int) -> np.ndarray:
        """The epoch's permutation, zero-padded to whole global batches."""
        world_b = self.world * batch_size
        order = np.zeros(-(-self.n // world_b) * world_b, np.int64)
        order[:self.n] = rng.permutation(self.n)
        return order

    def epoch(self, rng: np.random.Generator, batch_size: int):
        yield from self.steps_of(self.draw(rng, batch_size), batch_size)

    def steps_of(self, order: np.ndarray, batch_size: int):
        """This rank's share of each step of the epoch ``draw`` drew."""
        world_b = self.world * batch_size
        steps = len(order) // world_b
        lo = self.rank * batch_size
        mine = order.reshape(steps, world_b)[:, lo:lo + batch_size]
        valid = np.clip(self.n - np.arange(steps) * world_b - lo, 0,
                        batch_size)
        if self.ds is None:
            mine = torch.from_numpy(np.ascontiguousarray(mine)).to(
                self.device)
        for s in range(steps):
            nv = int(valid[s])
            yield (*self.batch(mine[s]),
                   _prefix_mask(nv, batch_size, self.device), nv)

    def eval_steps(self, batch_size: int):
        """The evaluation in the same layout (JAX train.py:673-695 on an
        N-device mesh): consecutive global batches of ``world *
        batch_size`` rows, the last padded with row 0 and masked, this
        rank's share of each."""
        world_b = self.world * batch_size
        for s in range(max(1, -(-self.n // world_b))):
            lo = s * world_b + self.rank * batch_size
            nv = min(max(self.n - lo, 0), batch_size)
            idx = np.concatenate([np.arange(lo, lo + nv),
                                  np.zeros(batch_size - nv, np.int64)])
            if self.ds is None:
                idx = torch.from_numpy(idx).to(self.device)
            yield (*self.batch(idx),
                   _prefix_mask(nv, batch_size, self.device))


class Replicated(Plane):
    """A plane over a process's local replicas: ``parts[i]`` is replica
    i's plane at world N (``Sharded`` or ``GlobalBatch`` with rank i),
    the epoch's permutations drawn once for all of them. A step yields a
    tuple of each replica's (batch, labels, mask, rows), an evaluation
    step a tuple of each replica's (batch, labels, mask)."""

    def __init__(self, parts: list):
        self.parts = parts

    @classmethod
    def over(cls, kind, ds: FeatureDataset, devices: list, **kw):
        """``kind`` (``Sharded`` or ``GlobalBatch``, with its other
        arguments ``kw``) at world ``len(devices)``, replica i on
        ``devices[i]``."""
        return cls([kind(ds, d, i, len(devices), **kw)
                    for i, d in enumerate(devices)])

    def epoch(self, rng: np.random.Generator, batch_size: int):
        drawn = self.parts[0].draw(rng, batch_size)
        yield from zip(*(p.steps_of(drawn, batch_size)
                         for p in self.parts))

    def eval_steps(self, batch_size: int):
        yield from zip(*(p.eval_steps(batch_size) for p in self.parts))


class StreamedShares(Plane):
    """The streamed plane over local replicas (JAX train.py:1245-1248 on
    an N-device mesh): the file's batches of ``len(devices) *
    batch_size`` rows, the tail padded with its first row and masked, each
    replica's contiguous share uploaded to its card."""

    def __init__(self, ds: StreamingFeatureDataset, devices: list):
        self.ds, self.devices = ds, devices

    def epoch(self, rng: np.random.Generator, batch_size: int):
        world_b = len(self.devices) * batch_size
        for batch, labels in self.ds.iter_batches(world_b, True, rng):
            nv = len(labels)
            idx = np.concatenate([np.arange(nv),
                                  np.zeros(world_b - nv, np.int64)])
            batch, labels = Batch(*(a[idx] for a in batch)), labels[idx]
            step = []
            for dev, (lo, hi) in zip(self.devices, shares(
                    world_b, world_b, len(self.devices))):
                rows = min(max(nv - lo, 0), batch_size)
                step.append((*_upload(Batch(*(a[lo:hi] for a in batch)),
                                      labels[lo:hi], dev),
                             _prefix_mask(rows, batch_size, dev), rows))
            yield tuple(step)


class Spill(Plane):
    """The spill (chunked-resident) plane (JAX train.py:1006-1175,
    :1317-1400): one card, a training set over the resident budget. The
    rows go up in slabs sized in wire bytes to a third of what the
    resident validation set leaves of the budget, whole batches each,
    on the wire ``DSP_TRAIN_SPILL_WIRE`` names (auto or float16: float16
    features; int8: the int8 wire with per-slab, per-field scales,
    dequantised after the gather on the card). Slab wires are built on
    the host once and cached up to ``DSP_SPILL_HOST_CACHE_BYTES``. One
    prefetch thread uploads the next slab on a copy stream while the
    current one trains, the next epoch's first slab included. An epoch
    draws the slab order, then per slab the order of its rows; before
    the last slab's rows it draws the next epoch's slab order when
    another epoch follows. Evaluations come at the first boundary of
    ``step_interval``-step chunks where the steps since the last one
    reach the interval, and at the epoch's end."""

    def __init__(self, ds: FeatureDataset, device: torch.device,
                 batch_size: int, budget: int, valid_bytes: int,
                 step_interval: int, epochs: int):
        wire = os.environ.get("DSP_TRAIN_SPILL_WIRE", "auto")
        if wire not in ("auto", "float16", "int8"):
            raise ValueError(f"DSP_TRAIN_SPILL_WIRE must be auto, float16 "
                             f"or int8 (got {wire!r})")
        # auto: float16, as --transfer_dtype auto (no remote link here)
        self.wire = "int8" if wire == "int8" else "float16"
        L, S = ds.signals.shape[1], ds.signals.shape[2]
        if self.wire == "int8":     # int8 codes/means/stds/signals, f16 lens
            bytes_per_row = L * (1 + 1 + 1 + 2 + S) + 1
        else:                       # int8 codes, f16 floats
            bytes_per_row = L * (1 + 2 + 2 + 2 + 2 * S) + 1
        B, n = batch_size, len(ds)
        slab_budget = max(B * bytes_per_row, (budget - 2 * valid_bytes) // 3)
        slab_rows = min(n, max(B, slab_budget // bytes_per_row))
        self.slab_rows = max(B, slab_rows - slab_rows % B)
        self.n_slabs = -(-n // self.slab_rows)
        self.ds, self.device, self.batch_size = ds, device, B
        self.step_interval, self._epochs_left = step_interval, epochs
        self._cache: dict = {}
        self._cache_cap = int(os.environ.get("DSP_SPILL_HOST_CACHE_BYTES",
                                             "") or 4 << 30)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="spill")
        self._fut = self._fut_si = self._next_order = None
        self._copy = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)
        self._eval_steps: set = set()
        self.counters = {"slabs": self.n_slabs, "slab_rows": self.slab_rows,
                         "wire": self.wire, "slab_uploads": 0,
                         "upload_seconds": 0.0, "wire_bytes": 0}

    def _slab_n(self, si: int) -> int:
        return min(self.slab_rows, len(self.ds) - si * self.slab_rows)

    def _slab_wire(self, si: int):
        """(kmer, means, stds, lens, signals, labels) of slab ``si`` on
        the wire, and the int8 wire's (3,) scales."""
        hit = self._cache.get(si)
        if hit is not None:
            return hit
        lo = si * self.slab_rows
        b, labels = self.ds.batch_at(slice(lo, lo + self._slab_n(si)))
        if self.wire == "int8":
            from .call_mods import quantize_for_wire
            b, scales = quantize_for_wire(b)
        else:
            scales = None
            b = Batch(np.asarray(b.kmer, np.int8),
                      *(np.asarray(a, np.float16) for a in b[1:]))
        out = ((*b, np.asarray(labels, np.int8)), scales)
        used = sum(a.nbytes for w, _ in self._cache.values() for a in w)
        if used + sum(a.nbytes for a in out[0]) <= self._cache_cap:
            self._cache[si] = out
        return out

    def _upload_slab(self, si: int):
        """Runs on the prefetch thread: the slab's wire on the card, its
        copy finished when this returns."""
        t0 = time.perf_counter()
        arrays, scales = self._slab_wire(si)
        host = [torch.from_numpy(a) for a in arrays]
        if scales is not None:
            host.append(torch.from_numpy(scales))
        if self._copy is not None:
            with torch.cuda.stream(self._copy):
                dev = [t.pin_memory().to(self.device, non_blocking=True)
                       for t in host]
            self._copy.synchronize()
        else:
            dev = host
        c = self.counters
        c["slab_uploads"] += 1
        c["wire_bytes"] += sum(a.nbytes for a in arrays)
        c["upload_seconds"] += time.perf_counter() - t0
        return dev

    def _prefetch(self, si: int | None) -> None:
        self._fut_si = si
        self._fut = None if si is None else self._pool.submit(
            self._upload_slab, si)

    def _eval_points(self, order) -> set:
        """The epoch's steps after which an evaluation runs (JAX
        train.py:1377-1397)."""
        points, step, carry, interval = set(), 0, 0, self.step_interval
        for si in order:
            steps_slab = -(-self._slab_n(int(si)) // self.batch_size)
            s0 = 0
            while s0 < steps_slab:
                k = min(interval, steps_slab - s0)
                s0, step, carry = s0 + k, step + k, carry + k
                if carry >= interval:
                    carry = 0
                    points.add(step)
        if carry:
            points.add(step)
        return points

    def evaluates_after(self, step: int, steps: int, interval: int) -> bool:
        return step in self._eval_steps

    def _gather(self, dev: list, idx: torch.Tensor):
        kmer, means, stds, lens, sig, labels = (a[idx] for a in dev[:6])
        means, stds, sig = means.float(), stds.float(), sig.float()
        if self.wire == "int8":
            scales = dev[6]
            means, stds, sig = (means * scales[0], stds * scales[1],
                                sig * scales[2])
        return (Batch(kmer.int(), means, stds, lens.float(), sig),
                labels.long())

    def epoch(self, rng: np.random.Generator, batch_size: int):
        if self._next_order is not None:
            order, self._next_order = self._next_order, None
        else:
            order = rng.permutation(self.n_slabs)
        more = self._epochs_left > 1
        self._epochs_left -= 1
        self._eval_steps = self._eval_points(order)
        if self._fut is None or self._fut_si != int(order[0]):
            self._prefetch(int(order[0]))
        for oi in range(self.n_slabs):
            dev = self._fut.result()
            if self._copy is not None:
                for t in dev:     # freed on the train stream, not the copy's
                    t.record_stream(torch.cuda.current_stream(self.device))
            if oi + 1 < self.n_slabs:
                self._prefetch(int(order[oi + 1]))
            elif more:
                self._next_order = rng.permutation(self.n_slabs)
                self._prefetch(int(self._next_order[0]))
            else:
                self._prefetch(None)
            n_sl = len(dev[5])
            perm = torch.from_numpy(rng.permutation(n_sl)).to(self.device)
            for lo in range(0, n_sl, batch_size):
                idx = perm[lo:lo + batch_size]
                yield (*self._gather(dev, idx), None, len(idx))
            del dev

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        self._fut = None


def resident_budget(device: torch.device) -> int:
    """Bytes of datasets the resident plane may keep on the device: half
    of the card's free memory, leaving the rest to the model, its
    activations and the optimizer (the CPU holds them where they are),
    and at most ``DSP_RESIDENT_MAX_BYTES`` where that is set (the JAX
    package's knob)."""
    cap = int(os.environ.get("DSP_RESIDENT_MAX_BYTES", "") or sys.maxsize)
    if device.type != "cuda":
        return cap
    free, _ = torch.cuda.mem_get_info(device)
    return min(free // 2, cap)


def _eval_terms(model: ModelBiLSTM, class_weights: torch.Tensor, batch,
                y: torch.Tensor, mask: torch.Tensor | None) -> list:
    """[weighted-CE numerator, weight sum, the five prediction counts
    (correct, total, tp, fp, fn)] of one evaluation step's rows."""
    logits, probs = model(batch)
    num, den = masked_ce_terms(logits, y, class_weights, mask)
    pred = torch.argmax(probs, dim=1)
    valid = torch.ones_like(y, dtype=torch.bool) if mask is None \
        else mask > 0
    return [num, den, torch.stack([
        ((pred == y) & valid).sum(), valid.sum(),
        (valid & (pred == 1) & (y == 1)).sum(),
        (valid & (pred == 1) & (y == 0)).sum(),
        (valid & (pred == 0) & (y == 1)).sum()]).float()]


@torch.no_grad()
def evaluate(model: ModelBiLSTM, source: Plane, batch_size: int,
             class_weights: torch.Tensor) -> dict:
    """Validation metrics (JAX train.py:673-695, and :320-335 with its
    eval-counts steps under a launch): per step of ``source.eval_steps``,
    the weighted CE of the rows it keeps (numerator and weight sum
    summed over ranks), averaged over steps; accuracy, precision and
    recall from the five prediction counts [correct, total, tp, fp, fn]
    summed over ranks. One inference forward a step; one all-reduce and
    one read of the results at the end."""
    return _evaluate(([_eval_terms(model, class_weights, *step)]
                      for step in source.eval_steps(batch_size)),
                     class_weights.device)


@torch.no_grad()
def evaluate_replicas(reps: list[Replica], source: Replicated,
                      batch_size: int) -> dict:
    """``evaluate`` over local replicas: each step's terms summed over
    the replicas (``replica_sum``) on replica 0's device, as JAX's
    sharded evaluation psums them over its mesh."""
    return _evaluate(([_eval_terms(r.model, r.class_weights, *part)
                       for r, part in zip(reps, step)]
                      for step in source.eval_steps(batch_size)),
                     reps[0].device)


def _evaluate(steps, device: torch.device) -> dict:
    """The metrics of ``evaluate`` from each step's replicas' terms."""
    nums, dens = [], []
    counts = torch.zeros(5, dtype=torch.float32, device=device)
    for terms in steps:
        num, den, cnt = replica_sum(terms)[0]
        nums.append(num)
        dens.append(den)
        counts += cnt
    if not nums:
        return {"loss": 0.0, "accuracy": 0.0, "precision": 0.0,
                "recall": 0.0, "batches": 0}
    num, den, counts = all_sum([torch.stack(nums), torch.stack(dens),
                                counts])
    loss = (num / torch.clamp(den, min=1e-12)).cpu().numpy()
    correct, total, tp, fp, fn = counts.cpu().numpy().astype(np.float64)
    return {"loss": float(np.mean(loss.astype(np.float64))),
            "accuracy": correct / total if total else 0.0,
            "precision": tp / (tp + fp) if tp + fp else 0.0,
            "recall": tp / (tp + fn) if tp + fn else 0.0,
            "batches": len(nums)}


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


def read_train_state_arrays(path: str) -> dict:
    """The arrays of a train state file, either container, unparsed."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_train_state(path: str, arrays: dict | None = None) -> dict:
    """A train state written by the port or by the JAX package: {params
    (the JAX layout), opt ({"count": n, slot: {name: array}}),
    optim_type, epoch, global_step, best_accuracy}. The JAX package's
    container (a pickled dict in ``train_state``) is read through an
    unpickler that admits numpy arrays and optax states only. ``arrays``:
    the file's arrays, read already (a multi-rank resume broadcasts
    them)."""
    arrays = dict(read_train_state_arrays(path) if arrays is None
                  else arrays)
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


def resume_state(path: str | None, rank: int, world: int) -> dict | None:
    """The train state to resume from, or None when there is none. In a
    multi-rank run rank 0 reads the file and broadcasts its arrays
    (JAX train.py:1185-1224): every rank starts from the same
    parameters, optimizer state, epoch, step and best accuracy, whatever
    its own model_dir holds."""
    if path is None:
        return None
    if world == 1:
        return load_train_state(path) if os.path.exists(path) else None
    arrays = None
    if rank == 0:
        arrays = read_train_state_arrays(path) if os.path.exists(path) \
            else {}
    arrays = broadcast_arrays(arrays)
    return load_train_state(path, arrays) if arrays else None


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


def as_devices(device) -> list[torch.device]:
    """A device, or a list of them (one replica each; a card may
    repeat), as a list."""
    return list(device) if isinstance(device, (list, tuple)) else [device]


def replicas_fit(nbytes: int, devices: list[torch.device]) -> bool:
    """Whether every card holds its replicas' blocks of ``nbytes`` of
    data, ``nbytes // len(devices)`` a replica, within its resident
    budget (two replicas on one card hold two blocks there)."""
    block = nbytes // len(devices)
    return all(block * devices.count(d) <= resident_budget(d)
               for d in set(devices))


def pick_plane(train_cfg: TrainConfig, train_ds, valid_ds,
               device, world: int) -> str:
    """The data plane the JAX package takes for these datasets (JAX
    train.py:825-1021): stream, resident, sharded, spill or host-fed.
    ``device``: a device, or the list of a process's replicas' devices
    (JAX's one process over N devices: sharded when the data fits the
    cards, else host-fed; no spill)."""
    devices = as_devices(device)
    if isinstance(train_ds, StreamingFeatureDataset):
        return "stream"
    if train_cfg.device_resident != "auto":
        return "host-fed"
    total = train_ds.nbytes + valid_ds.nbytes
    if len(devices) > 1:
        return "sharded" if replicas_fit(total, devices) else "host-fed"
    budget = resident_budget(devices[0])
    if world > 1:
        return "sharded" if total // world <= budget else "host-fed"
    if total <= budget:
        return "resident"
    return "spill" if valid_ds.nbytes * 4 <= budget else "host-fed"


def train_loop(model_cfg: ModelConfig, train_cfg: TrainConfig,
               train_ds: FeatureDataset | StreamingFeatureDataset,
               valid_ds: FeatureDataset, model_dir: str | None,
               device, init_model: str | None = None,
               verbose: bool = True, resume: bool = False) -> dict:
    """The training loop (JAX train.py:802-1435), on one card, on a list
    of a process's cards (``device``: a list of devices, one replica
    each; JAX's one process over N devices) or as one rank of a
    multi-process launch (parallel/dist.py). With a ``model_dir`` rank 0
    saves the train state after every epoch, and with ``resume`` the run
    continues from that file when it exists. Returns the best accuracy
    and checkpoint (rank 0), the final parameters (numpy pytree; replica
    0's, and the other replicas' in ``replica_params``), the steps'
    losses and the validation accuracies of this run, and its
    counters."""
    t_start = time.time()
    if train_cfg.device_resident not in ("auto", "never"):
        raise ValueError("device_resident must be auto|never")
    devices = as_devices(device)
    device, n = devices[0], len(devices)
    rank, world = process_info()
    if world > 1 and isinstance(train_ds, StreamingFeatureDataset):
        raise ValueError("streaming datasets are single-host only; "
                         "pre-shard the file per host instead")
    if world > 1 and n > 1:
        raise ValueError("under a multi-process launch each rank trains "
                         "on one card")
    verbose = verbose and rank == 0
    plane = pick_plane(train_cfg, train_ds, valid_ds, devices, world)

    rng_np = np.random.default_rng(train_cfg.seed)
    params = init_params(model_cfg, train_cfg.seed)
    if init_model is not None:
        if verbose:
            print(f"loading pre-trained model: {init_model}")
        params = load_any_checkpoint(init_model, model_cfg)
    state_path = (train_state_path(model_dir, model_cfg.module)
                  if model_dir is not None else None)
    st = resume_state(state_path, rank, world) if resume else None
    if st is not None:
        params = st["params"]

    # the global batch rounded up to a multiple of the ranks or local
    # replicas, each its share; equal step counts on every rank (JAX
    # train.py:826-862)
    shards = world * n
    B = local_batch_target(train_cfg.batch_size, shards) // shards
    steps_per_epoch = max(1, -(-shard_rows(len(train_ds), shards) // B))
    schedule = step_decay_schedule(
        train_cfg.lr, steps_per_epoch, train_cfg.lr_decay_step,
        train_cfg.lr_decay)
    reps = [Replica(params, model_cfg, d, train_cfg.optim_type, schedule,
                    train_cfg.pos_weight) for d in devices]
    model = reps[0].model

    best_accuracy = 0.0
    best_ckpt = None
    global_step = start_epoch = 0
    if st is not None:
        for r in reps:
            restore_optimizer(r.opt, r.model, st, state_path)
        start_epoch, global_step = st["epoch"], st["global_step"]
        best_accuracy = st["best_accuracy"]
        if verbose:
            print("resuming training from epoch {} (step {})".format(
                start_epoch, global_step))

    if n > 1 and plane == "sharded":
        train_src = Replicated.over(Sharded, train_ds, devices,
                                    steps=steps_per_epoch)
        valid_src = Replicated.over(Sharded, valid_ds, devices)
    elif n > 1:
        train_src = (StreamedShares(train_ds, devices) if plane == "stream"
                     else Replicated.over(GlobalBatch, train_ds, devices,
                                          resident=False))
        valid_src = Replicated.over(GlobalBatch, valid_ds, devices,
                                    resident=False)
    elif plane == "stream":
        train_src, valid_src = (Streamed(train_ds, device),
                                HostFed(valid_ds, device))
    elif plane == "spill":
        train_src = Spill(train_ds, device, B, resident_budget(device),
                          valid_ds.nbytes, train_cfg.step_interval,
                          train_cfg.max_epoch_num - start_epoch)
        valid_src = Resident(valid_ds, device)
    elif world > 1:
        cls = Sharded if plane == "sharded" else ShardedHostFed
        train_src = cls(train_ds, device, rank, world, steps_per_epoch)
        valid_src = cls(valid_ds, device, rank, world)
    else:
        cls = Resident if plane == "resident" else HostFed
        train_src, valid_src = cls(train_ds, device), cls(valid_ds, device)
    if verbose:
        if plane == "spill":
            c = train_src.counters
            print("chunked-resident (spill) data plane: {} train rows in {} "
                  "slab(s) of <= {} rows ({} wire), {} valid rows on "
                  "{}".format(len(train_ds), c["slabs"], c["slab_rows"],
                              c["wire"], len(valid_ds), device))
        elif plane == "sharded" and n > 1:
            print("sharded device-resident data plane: {} train + {} "
                  "valid rows over {} devices ({}), each its block".format(
                      len(train_ds), len(valid_ds), n,
                      ", ".join(map(str, devices))))
        elif plane in ("resident", "sharded"):
            print("{}device-resident data plane: {} train + {} valid rows "
                  "on {}{}".format(
                      "sharded " if world > 1 else "", len(train_ds),
                      len(valid_ds), device,
                      f" (each of {world} ranks its block)"
                      if world > 1 else ""))
        print("total_step: {}".format(steps_per_epoch))

    def run_eval() -> dict:
        if n > 1:
            return evaluate_replicas(reps, valid_src, B)
        return evaluate(model, valid_src, B, reps[0].class_weights)

    start_step = global_step
    epochs_run = start_epoch
    step_losses: list[float] = []
    valid_accuracies: list[float] = []
    epoch_seconds: list[float] = []
    counters = {"train_seconds": 0.0, "eval_seconds": 0.0, "eval_tiles": 0,
                "train_rows": 0, "epoch_train_seconds": []}
    try:
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
                for d in set(devices):
                    sync_device(d)
                t_eval = time.time()
                counters["train_seconds"] += t_eval - t_interval
                counters["epoch_train_seconds"][-1] += t_eval - t_interval
                losses = torch.stack(tlosses).cpu().numpy().tolist()
                step_losses.extend(losses)
                stats = run_eval()
                counters["eval_tiles"] += stats["batches"]
                v_acc = stats["accuracy"]
                valid_accuracies.append(v_acc)
                if v_acc > epoch_best:
                    epoch_best = v_acc
                    if epoch_best > best_accuracy - 0.0002:
                        if model_dir is not None and rank == 0:
                            best_ckpt = ckpt_name(
                                model_dir, model_cfg.module,
                                model_cfg.seq_len, model_cfg.signal_len,
                                epoch + 1)
                            save_checkpoint(best_ckpt,
                                            params_to_numpy(model),
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
                                  float(np.mean(losses)), stats["loss"],
                                  v_acc, stats["precision"],
                                  stats["recall"], epoch_best,
                                  time.time() - tic))
                    sys.stdout.flush()
                tlosses = []
                tic = t_interval = time.time()
                counters["eval_seconds"] += t_interval - t_eval

            for i, step in enumerate(train_src.epoch(rng_np, B)):
                parts = step if n > 1 else (step,)
                gens = (replica_generators(train_cfg.seed + 1, global_step,
                                           reps, rank, world)
                        if model_cfg.dropout_rate > 0 else [None] * n)
                tlosses.append(train_step(
                    reps, [p[:3] for p in parts], train_cfg.clip_grad,
                    gens))
                counters["train_rows"] += sum(p[3] for p in parts)
                global_step += 1
                if train_src.evaluates_after(i + 1, steps_per_epoch,
                                             train_cfg.step_interval):
                    eval_boundary(i + 1)
            epochs_run = epoch + 1
            epoch_seconds.append(time.time() - epoch_t0)
            if state_path is not None and rank == 0:
                save_train_state(state_path, model, reps[0].opt, epoch + 1,
                                 global_step, best_accuracy)
            if no_best_model and epoch >= train_cfg.min_epoch_num - 1:
                if verbose:
                    print("early stop!")
                break
    finally:
        train_src.close()

    if verbose:
        print("[main] train costs {:.1f} seconds, best accuracy: {}".format(
            time.time() - t_start, best_accuracy))
    return {"best_accuracy": best_accuracy, "best_ckpt": best_ckpt,
            "epochs_run": epochs_run, "params": params_to_numpy(model),
            "replica_params": [params_to_numpy(r.model) for r in reps[1:]],
            "devices": [str(d) for d in devices],
            "steps": global_step, "start_epoch": start_epoch,
            "start_step": start_step, "step_losses": step_losses,
            "valid_accuracies": valid_accuracies,
            "epoch_seconds": epoch_seconds,
            "resident": plane in ("resident", "sharded"), "plane": plane,
            "rank": rank, "world_size": world, "local_batch": B,
            "spill": (train_src.counters if plane == "spill" else None),
            **counters}


def use_stream(args) -> bool:
    """--stream yes, or auto on a training file over STREAM_MIN_BYTES in
    a single-process run (JAX train.py:763-774)."""
    return args.stream == "yes" or (
        args.stream == "auto" and process_info()[1] == 1
        and os.path.getsize(args.train_file) > STREAM_MIN_BYTES)


def train_configs(args, device: torch.device
                  ) -> tuple[ModelConfig, TrainConfig]:
    """The model and training configurations of parsed ``train``
    arguments (compute dtype ``auto`` resolved for ``device``)."""
    return (model_config_from_args(args, device, args.dropout_rate),
            TrainConfig(
                batch_size=args.batch_size, lr=args.lr,
                lr_decay=args.lr_decay, lr_decay_step=args.lr_decay_step,
                max_epoch_num=args.max_epoch_num,
                min_epoch_num=args.min_epoch_num,
                step_interval=args.step_interval,
                pos_weight=args.pos_weight, optim_type=args.optim_type,
                device_resident=args.device_resident))


def train(args) -> dict:
    """CLI entry mirroring reference train(args) (train.py:22), over
    every visible card unless ``--device`` names one (utils/device.
    resolve_devices). Returns train_loop's summary."""
    for path in (args.train_file, args.valid_file):
        if not os.path.exists(path):
            raise ValueError(f"{path} does not exist!")
    devices = resolve_devices(args.device)
    device = devices[0]
    print("[main] train starts..")
    model_cfg, train_cfg = train_configs(args, device)

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
        if not args.resume and process_info()[0] == 0:
            clean_old_ckpts(model_dir, model_cfg.module)
    model_dir += "/"

    launches0 = kernel_launches()
    res = train_loop(model_cfg, train_cfg, train_ds, valid_ds, model_dir,
                     devices, init_model=args.init_model, resume=args.resume)
    if args.verbose_stages:
        print("[stages] " + json.dumps({
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "devices": res["devices"],
            "compute_dtype": model_cfg.compute_dtype,
            "recurrence": model_cfg.recurrence,
            "plane": res["plane"],
            "rank": res["rank"], "world_size": res["world_size"],
            "local_batch": res["local_batch"], "spill": res["spill"],
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
