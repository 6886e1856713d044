"""denoise — cross-rank filter-and-retrain label cleaning (counterpart of
deepsignal_plant_tpu/pipeline/denoise.py).

Reference behavior (denoise.py:318-383): for up to ``--iterations``, run
``--rounds`` of cross-rank (random-halve the train file; train a fresh
small model on each half for ``--epoch_num`` epochs — stopping early once
the epoch's running train accuracy >= 0.95 — and score the held-out
half), average each sample's positive-class probability over its
scores, keep positives with mean >= score_cf (and with ``is_filter_fn``
negatives < 1 - score_cf), re-balance negatives to the positives' k-mer
distribution, shuffle-concat into the next iteration's train file; stop
when the kept ratio >= kept_ratio.

Every random choice is drawn in the JAX package's order from
``default_rng(--seed)`` (the k-mer reselection's ``random.Random`` seed
first, then per round the half split and the mini-training seed, then
``shuffle_concat``'s permutations), so from the same initial parameters
both packages keep the same rows. The mini-trainings run on the train
loop's step and data planes (pipeline/train.py): resident when both
halves fit the card's budget, host-fed otherwise; their dropout masks
come from (seed + 7, step), as JAX folds the step into PRNGKey(seed + 7).

Under a launch of N ranks (parallel/dist.py) the ranks compute what the
JAX package's denoise computes in one process over N devices: the batch
is rounded up to a multiple of N and each mini-training runs data
parallel, on the sharded-resident plane (``Sharded``) when JAX's rule
takes it (``device_resident`` auto, at least
``DSP_DENOISE_RESIDENT_MIN_ROWS`` training rows, default 100,000, and a
rank's share of both halves within the resident budget) and on the
global-batch plane (``GlobalBatch``) otherwise. The accuracy checks sum
their counts over ranks, each rank scores one block of rows and the
blocks are gathered in row order, so every rank holds the same scores.
Rank 0 alone writes and removes files, draws the k-mer reselection and
the shuffle, and sends its generator's state to the other ranks after
each iteration: every rank draws the same halves and seeds.

One process over N local cards (``--device cuda`` or none outside a
launch: every visible card, utils/device.resolve_devices) computes the
same: ``CrossRankTrainer`` holds a model replica a card, replica i in
the place of rank i. Its planes are ``Replicated`` over ``Sharded`` or
``GlobalBatch`` at world N by the same rule (each card within its
budget), a step is train.train_step, the accuracy checks sum the
replicas' counts, and each replica scores its block of rows, put back
in row order. The process does the file work alone; nothing is
broadcast.
"""
from __future__ import annotations

import contextlib
import json
import os
import random
import sys
import time

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, model_config_from_args
from ..io.dataset import FeatureDataset
from ..models.bilstm import init_params
from ..ops.fused_lstm import kernel_launches, kernel_launches_since
from ..ops.optim import step_decay_schedule
from ..parallel.dist import process_info
from ..parallel.multihost import allgather_bytes, barrier, broadcast_arrays
from ..utils import metrics as M
from ..utils.bases import str2bool
from ..utils.device import resolve_devices
from ..utils.fileio import (count_lines, filter_rows_by_label,
                            select_neg_rows_as_pos_kmer_dist, shuffle_concat)
from .train import (GlobalBatch, HostFed, Replica, Replicated, Resident,
                    Sharded, as_devices, replica_generators,
                    reduce_replicas, replicas_fit, resident_budget,
                    shard_rows, sync_device, train_step)


def resident_min_rows() -> int:
    """The fewest training rows for which a multi-rank mini-training takes
    the sharded-resident plane (the JAX package's
    ``DSP_DENOISE_RESIDENT_MIN_ROWS``, default 100,000)."""
    return int(os.environ.get("DSP_DENOISE_RESIDENT_MIN_ROWS", "")
               or 100_000)


def get_model_type_str(model_type: str, is_base: bool,
                       is_signallen: bool) -> str:
    """File-tag string (process_utils.py:533-539)."""
    if model_type != "signal_bilstm":
        basestr = "with_base" if is_base else "no_base"
        slenstr = "with_slen" if is_signallen else "no_slen"
        return "_".join([model_type, basestr, slenstr])
    return model_type


class CrossRankTrainer:
    """Train a fresh model on one half, score the other (JAX
    denoise.py:166-298), on this rank's share of each step under a
    launch or on every local card's share (``device``: a device or a
    list of them, one replica each), and count what it ran."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 device):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.devices = as_devices(device)
        self.device = self.devices[0]
        self.rank, self.world = process_info()
        if self.world > 1 and len(self.devices) > 1:
            raise ValueError("under a multi-process launch each rank "
                             "denoises on one card")
        # devices of the data-parallel axis: the ranks or the replicas
        self.shards = self.world * len(self.devices)
        # the batch rounded up to a multiple of them (JAX
        # denoise.py:59), each its share
        self.local_batch = -(-train_cfg.batch_size // self.shards)
        self.batch_size = self.local_batch * self.shards
        self.counters = {"mini_trainings": 0, "resident_trainings": 0,
                         "sharded_trainings": 0, "planes_built": 0,
                         "steps": 0, "train_rows": 0, "accuracy_checks": 0,
                         "score_tiles": 0, "train_seconds": 0.0,
                         "score_seconds": 0.0}
        # (dataset, plane kind, its plane) of the last call: a round's
        # second call swaps the same two halves, so each half uploads
        # once a round
        self._held: list[tuple] = []

    def _kind(self, train_ds: FeatureDataset,
              score_ds: FeatureDataset) -> tuple:
        """(plane class, world size, resident) of this call: one card
        trains resident when both halves fit the budget, else host-fed;
        N ranks or local cards take JAX's rule (denoise.py:92-107)
        between the sharded-resident and the global-batch plane."""
        auto = self.train_cfg.device_resident == "auto"
        both = train_ds.nbytes + score_ds.nbytes
        if len(self.devices) > 1:
            # local replicas: each card holds its replicas' blocks, or
            # (global-batch plane) their copies of both halves
            if (auto and len(train_ds) >= resident_min_rows()
                    and replicas_fit(both, self.devices)):
                return Sharded, self.shards, True
            return GlobalBatch, self.shards, auto and replicas_fit(
                both * self.shards, self.devices)
        budget = resident_budget(self.device)
        if self.world == 1:
            resident = auto and both <= budget
            return (Resident if resident else HostFed), 1, resident
        if (auto and len(train_ds) >= resident_min_rows()
                and both // self.world <= budget):
            return Sharded, self.world, True
        return GlobalBatch, self.world, auto and both <= budget

    def _plane(self, kind: tuple, ds: FeatureDataset):
        plane, world, resident = kind
        extra = {"resident": resident} if plane is GlobalBatch else {}
        if len(self.devices) > 1:
            return Replicated.over(plane, ds, self.devices, **extra)
        if plane in (Sharded, GlobalBatch):
            return plane(ds, self.device, self.rank, world, **extra)
        return plane(ds, self.device)

    def _sources(self, train_ds: FeatureDataset, score_ds: FeatureDataset):
        """The plane kind and the planes of both datasets, reusing the
        last call's planes of the same kind."""
        kind = self._kind(train_ds, score_ds)
        held = {id(ds): src for ds, k, src in self._held if k == kind}
        self._held = []
        for ds in (train_ds, score_ds):
            src = held.get(id(ds))
            if src is None:
                src = self._plane(kind, ds)
                self.counters["planes_built"] += 1
            self._held.append((ds, kind, src))
        return kind, self._held[0][2], self._held[1][2]

    def _accuracy(self, reps: list[Replica], parts, sharded: bool):
        """The post-update, no-dropout accuracy of the step's batch
        (``parts``: each replica's (batch, labels, mask)). Over ranks or
        replicas the correct and valid counts of their rows are summed
        first: the global-batch plane divides as the JAX host path's
        ``M.accuracy`` on the global batch, the sharded plane in float32
        as JAX's in-scan signal (train.py:474-482)."""
        with torch.no_grad():
            preds = [torch.argmax(r.model(batch)[1], dim=1)
                     for r, (batch, _, _) in zip(reps, parts)]
        _, labels, mask = parts[0]
        if mask is None:
            return M.accuracy(labels.cpu().numpy(), preds[0].cpu().numpy())
        counts = [[((pred == y).float() * m).sum(), m.sum()]
                  for pred, (_, y, m) in zip(preds, parts)]
        ok, tot = (float(x) for x in reduce_replicas(counts)[0])
        if sharded:
            return np.float32(ok) / np.float32(max(tot, 1.0))
        return ok / tot if tot else 0.0

    def _score(self, reps: list[Replica], src, n: int) -> np.ndarray:
        """prob_1 of the ``n`` rows of ``src``. Over N ranks or replicas
        device d (rank or replica) scores rows [d * R, (d + 1) * R), R =
        ceil(n / N) (the sharded plane's block, JAX
        denoise.py:282-295), in tiles of its batch share; the replicas'
        blocks are put in order, and the ranks' gathered in rank
        order."""
        c, b = self.counters, self.local_batch
        parts = src.parts if len(reps) > 1 else [src]
        blocks = []
        for j, (rep, part) in enumerate(zip(reps, parts)):
            lo, hi = 0, n
            if self.shards > 1:     # device d: the rank or the replica
                rows = shard_rows(n, self.shards)
                lo = min((self.rank + j) * rows, n)
                hi = min(lo + rows, n)
            # the sharded plane holds its block from local row 0
            off = lo if isinstance(part, Sharded) else 0
            probs1 = []
            with torch.no_grad():
                for s in range(lo, hi, b):
                    batch, _ = part.batch(slice(s - off,
                                                min(s + b, hi) - off))
                    probs1.append(rep.model(batch)[1][:, 1])
                    c["score_tiles"] += 1
            blocks.append(torch.cat(probs1).cpu().numpy() if probs1
                          else np.empty(0, np.float32))
        out = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
        if self.world == 1:
            return out
        return np.concatenate([np.frombuffer(part, np.float32) for part in
                               allgather_bytes(out.tobytes())])

    def train_then_score(self, train_ds: FeatureDataset,
                         score_ds: FeatureDataset, seed: int,
                         epoch_num: int, step_interval: int,
                         verbose: bool = False) -> np.ndarray:
        """Train a fresh model on train_ds and return prob_1 of every
        score_ds row (reference train_1time, denoise.py:28-170)."""
        cfg, tcfg, c = self.model_cfg, self.train_cfg, self.counters
        n = len(self.devices)
        t0 = time.time()
        rng_np = np.random.default_rng(seed)
        params = init_params(cfg, seed)
        steps_per_epoch = max(1, -(-len(train_ds) // self.batch_size))
        schedule = step_decay_schedule(tcfg.lr, steps_per_epoch, 2, 0.1)
        reps = [Replica(params, cfg, d, "Adam", schedule, tcfg.pos_weight)
                for d in self.devices]
        (plane, _, resident), train_src, score_src = self._sources(
            train_ds, score_ds)
        sharded = plane is Sharded
        if sharded:
            for part in (train_src.parts if n > 1 else [train_src]):
                part.steps = steps_per_epoch
        c["mini_trainings"] += 1
        c["resident_trainings"] += resident
        c["sharded_trainings"] += sharded

        gstep = 0
        for epoch in range(epoch_num):
            epoch_accs: list = []
            for i, step in enumerate(
                    train_src.epoch(rng_np, self.local_batch)):
                step = step if n > 1 else (step,)
                parts = [p[:3] for p in step]
                gens = (replica_generators(seed + 7, gstep, reps, self.rank,
                                           self.world)
                        if cfg.dropout_rate > 0 else [None] * n)
                loss = train_step(reps, parts, tcfg.clip_grad, gens)
                gstep += 1
                c["train_rows"] += sum(p[3] for p in step)
                if (i + 1) % step_interval == 0:
                    acc = self._accuracy(reps, parts, sharded)
                    epoch_accs.append(acc)
                    c["accuracy_checks"] += 1
                    if verbose and self.rank == 0:
                        print("Epoch [{}/{}], Step [{}/{}], "
                              "TrainLoss: {:.4f}, Accuracy: {:.4f}".format(
                                  epoch + 1, epoch_num, i + 1,
                                  steps_per_epoch, float(loss), acc))
                        sys.stdout.flush()
            # reference early break: running train accuracy >= .95
            # (denoise.py:108); the sharded plane's mean in float32, as
            # JAX's over its in-scan signal
            if epoch_accs and float(np.mean(np.asarray(
                    epoch_accs, np.float32 if sharded else np.float64))
                    ) >= 0.95:
                break
        c["steps"] += gstep
        for d in set(self.devices):
            sync_device(d)
        t1 = time.time()
        out = self._score(reps, score_src, len(score_ds))
        c["train_seconds"] += t1 - t0
        c["score_seconds"] += time.time() - t1
        return out.astype(np.float32)


def share_rng(rng: np.random.Generator, rank: int) -> None:
    """Set every rank's ``rng`` to rank 0's state (rank 0's file work
    draws from it alone)."""
    state = broadcast_arrays(
        {"state": np.frombuffer(json.dumps(rng.bit_generator.state)
                                .encode(), np.uint8)} if rank == 0 else None)
    rng.bit_generator.state = json.loads(state["state"].tobytes())


def denoise(args) -> str:
    """CLI entry mirroring reference denoise(args) (denoise.py:318), over
    every visible card unless ``--device`` names one, or as one rank of
    a launch. Returns the path of the final denoised training file, the
    same on every rank."""
    total_start = time.time()
    rank, world = process_info()
    lead = rank == 0
    say = print if lead else (lambda *a, **k: None)
    devices = resolve_devices(args.device)
    device = devices[0]
    model_cfg = model_config_from_args(args, device, args.dropout_rate)
    train_cfg = TrainConfig(batch_size=args.batch_size, lr=args.lr,
                            pos_weight=args.pos_weight,
                            step_interval=args.step_interval,
                            device_resident=args.device_resident)
    modeltype_str = get_model_type_str(args.model_type,
                                       str2bool(args.is_base),
                                       str2bool(args.is_signallen))
    is_filter_fn = str2bool(args.is_filter_fn)
    rng = np.random.default_rng(args.seed)
    if world > 1:       # an unseeded run draws rank 0's entropy everywhere
        share_rng(rng, rank)
    # the k-mer-balanced negative reselection draws with random.Random's
    # API (rng.sample), seeded from the same stream; rank 0 alone uses it
    py_rng = random.Random(int(rng.integers(1 << 62)))

    train_file = args.train_file
    # all-negative pool for k-mer-balanced reselection (denoise.py:296)
    fname, fext = os.path.splitext(train_file)
    train_neg_file = fname + ".neg_all." + modeltype_str + fext
    if lead:
        filter_rows_by_label(train_file, train_neg_file, 0)

    trainer = CrossRankTrainer(model_cfg, train_cfg, devices)
    launches0 = kernel_launches()
    final_file = train_file
    iterations_run = 0
    for iter_c in range(args.iterations):
        iterations_run += 1
        say("\n###### cross rank to clean samples, Iter: {} ######".format(
            iter_c + 1))
        ds = FeatureDataset.from_file(train_file, model_cfg.seq_len,
                                      model_cfg.signal_len)
        n = len(ds)
        half = n // 2
        score_sum = np.zeros(n, np.float64)
        score_cnt = np.zeros(n, np.int64)
        for r in range(args.rounds):
            say("##########Train Cross Rank, Iter {}, Round {}##########"
                .format(iter_c + 1, r + 1))
            perm = rng.permutation(n)
            idx1, idx2 = np.sort(perm[:half]), np.sort(perm[half:])
            seed = int(rng.integers(1 << 30))
            h1, h2 = ds.take(idx1), ds.take(idx2)
            p2 = trainer.train_then_score(h1, h2, seed, args.epoch_num,
                                          args.step_interval)
            p1 = trainer.train_then_score(h2, h1, seed + 1, args.epoch_num,
                                          args.step_interval)
            score_sum[idx2] += p2
            score_cnt[idx2] += 1
            score_sum[idx1] += p1
            score_cnt[idx1] += 1
        mean_scores = score_sum / np.maximum(score_cnt, 1)

        if iter_c == 0 and args.fst_iter_prob and lead:
            with open(args.train_file + ".probs_1stiter.txt", "w") as wf:
                for i in range(n):
                    wf.write("\t".join([str(i), str(mean_scores[i])]) + "\n")

        # ---- clean samples (denoise.py:216-293) ----
        say("\n###### clean the samples ######")
        labels = ds.labels
        pos_mask = labels == 1
        neg_mask = ~pos_mask
        keep_pos = pos_mask & (mean_scores >= args.score_cf)
        keep_neg = (neg_mask & (mean_scores < 1 - args.score_cf)
                    if is_filter_fn else np.zeros(n, bool))
        n_pos, n_neg = int(pos_mask.sum()), int(neg_mask.sum())
        say("There are {} positive, {} negative samples in total;".format(
            n_pos, n_neg))
        left_ratio = float(keep_pos.sum()) / n_pos if n_pos else 0.0
        left_ratio2 = float(keep_neg.sum()) / n_neg if n_neg else 0.0
        say("{} ({}) high quality positive samples left, "
            "{} ({}) high quality negative samples left".format(
                int(keep_pos.sum()), round(left_ratio, 6),
                int(keep_neg.sum()), round(left_ratio2, 6)))
        if is_filter_fn:
            left_ratio = (left_ratio + left_ratio2) / 2

        # ---- rebuild train file (denoise.py:347-375), on rank 0 ----
        say("\n#####concat denoised file#####")
        pos_num = int(keep_pos.sum())
        tag = ".denoise_fpnp" if is_filter_fn else ".denoise_fp"
        next_file = (os.path.splitext(args.train_file)[0] + "." +
                     modeltype_str + tag + str(iter_c + 1) + fext
                     if pos_num > 0 else None)
        if lead:
            _rebuild(args, train_file, next_file, train_neg_file, keep_pos,
                     keep_neg, is_filter_fn, modeltype_str, rng, py_rng)
        if next_file is not None:
            train_file = final_file = next_file
        else:
            say("WARNING: The denoise module denoised all samples in the "
                "train_file!!!")
        say("#####concat denoised file, finished!#####")
        if world > 1:   # rank 0's file work done: its draws reach every rank
            share_rng(rng, rank)

        if left_ratio >= args.kept_ratio or pos_num == 0:
            break

    if lead:
        os.remove(train_neg_file)
    barrier()
    seconds = time.time() - total_start
    say("###### denoised file for training: {}".format(final_file))
    say("###### denoise totally costs {:.2f} seconds".format(seconds))
    if args.verbose_stages:
        c = trainer.counters
        print("[stages] " + json.dumps({
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "compute_dtype": model_cfg.compute_dtype,
            "recurrence": model_cfg.recurrence,
            "devices": [str(d) for d in devices],
            "rank": rank, "world_size": world,
            "batch_size": trainer.batch_size,
            "local_batch": trainer.local_batch,
            "iterations_run": iterations_run, **c,
            # an accuracy check runs a forward on every replica
            "forward_tiles": (c["accuracy_checks"] * len(devices)
                              + c["score_tiles"]),
            "kernel_launches": kernel_launches_since(launches0),
            "mini_trainings_per_s": (c["mini_trainings"] / seconds
                                     if seconds else 0.0),
            "samples_per_s": (c["train_rows"] / c["train_seconds"]
                              if c["train_seconds"] else 0.0),
            "seconds": seconds, "final_file": final_file}))
    return final_file


def _rebuild(args, train_file: str, next_file: str | None,
             train_neg_file: str, keep_pos: np.ndarray,
             keep_neg: np.ndarray, is_filter_fn: bool, modeltype_str: str,
             rng: np.random.Generator, py_rng: random.Random) -> None:
    """One iteration's file work (denoise.py:216-375): the kept rows to
    the pos (and with ``is_filter_fn`` neg) files, negatives reselected
    to the positives' k-mer distribution, both shuffled into
    ``next_file`` (None when no positive was kept), and the working files
    removed. The previous iteration's file goes only after its
    replacement exists: when this iteration keeps no positive, it is the
    returned final file."""
    fname, fext = os.path.splitext(args.train_file)
    if train_file == args.train_file:
        stem = fname + "." + modeltype_str
    else:
        stem = os.path.splitext(train_file)[0]
    pos_file = stem + ".pos.cf" + str(args.score_cf) + fext
    neg_file = (stem + ".neg.cf" + str(args.score_cf) + fext
                if is_filter_fn else None)
    _write_selected_rows(train_file, pos_file, keep_pos, neg_file, keep_neg)
    if next_file is not None:
        pos_num = int(keep_pos.sum())
        nfname, nfext = os.path.splitext(train_neg_file)
        seled_neg = nfname + ".r" + str(pos_num) + nfext
        if neg_file is None:
            select_neg_rows_as_pos_kmer_dist(pos_file, train_neg_file,
                                             seled_neg, rng=py_rng)
        elif pos_num <= count_lines(neg_file):
            select_neg_rows_as_pos_kmer_dist(pos_file, neg_file, seled_neg,
                                             rng=py_rng)
            os.remove(neg_file)
        else:
            seled_neg = neg_file
        shuffle_concat(pos_file, seled_neg, next_file, rng=rng)
        os.remove(seled_neg)
        if train_file != args.train_file:
            os.remove(train_file)
    elif neg_file is not None:
        os.remove(neg_file)
    os.remove(pos_file)


def _write_selected_rows(src: str, pos_file: str, keep_pos: np.ndarray,
                         neg_file: str | None,
                         keep_neg: np.ndarray) -> None:
    """Rows of ``src`` kept as positives to ``pos_file``, and with a
    ``neg_file`` the negatives kept to it, in file order."""
    with open(src) as rf, open(pos_file, "w") as wfp, (
            open(neg_file, "w") if neg_file is not None
            else contextlib.nullcontext()) as wfn:
        for i, line in enumerate(rf):
            if keep_pos[i]:
                wfp.write(line)
            elif wfn is not None and keep_neg[i]:
                wfn.write(line)
