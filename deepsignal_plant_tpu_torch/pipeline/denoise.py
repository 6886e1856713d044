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
from ..models.bilstm import ModelBiLSTM, init_params
from ..ops.optim import Optimizer, step_decay_schedule
from ..parallel.dist import refuse_launch
from ..utils import metrics as M
from ..utils.bases import str2bool
from ..utils.device import resolve_device
from ..utils.fileio import (count_lines, filter_rows_by_label,
                            select_neg_rows_as_pos_kmer_dist, shuffle_concat)
from .train import (HostFed, Resident, kernel_launches,
                    kernel_launches_since, resident_budget, step_generator,
                    sync_device, train_step)


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
    denoise.py:166-221), and count what it ran."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 device: torch.device):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = device
        self.class_weights = torch.tensor([1.0, train_cfg.pos_weight],
                                          dtype=torch.float32, device=device)
        self.counters = {"mini_trainings": 0, "resident_trainings": 0,
                         "planes_built": 0, "steps": 0, "train_rows": 0,
                         "accuracy_checks": 0, "score_tiles": 0,
                         "train_seconds": 0.0, "score_seconds": 0.0}
        # (dataset, its plane) of the last call: a round's second call
        # swaps the same two halves, so each half uploads once a round
        self._held: list[tuple[FeatureDataset, object]] = []

    def _sources(self, train_ds: FeatureDataset, score_ds: FeatureDataset):
        """The planes of both datasets, reusing the last call's."""
        resident = (self.train_cfg.device_resident == "auto"
                    and train_ds.nbytes + score_ds.nbytes
                    <= resident_budget(self.device))
        plane = Resident if resident else HostFed
        held = {id(ds): src for ds, src in self._held
                if type(src) is plane}
        self._held = []
        for ds in (train_ds, score_ds):
            src = held.get(id(ds))
            if src is None:
                src = plane(ds, self.device)
                self.counters["planes_built"] += 1
            self._held.append((ds, src))
        return plane, self._held[0][1], self._held[1][1]

    def train_then_score(self, train_ds: FeatureDataset,
                         score_ds: FeatureDataset, seed: int,
                         epoch_num: int, step_interval: int,
                         verbose: bool = False) -> np.ndarray:
        """Train a fresh model on train_ds and return prob_1 of every
        score_ds row (reference train_1time, denoise.py:28-170)."""
        cfg, tcfg, dev, c = (self.model_cfg, self.train_cfg, self.device,
                             self.counters)
        t0 = time.time()
        rng_np = np.random.default_rng(seed)
        model = ModelBiLSTM.from_params(init_params(cfg, seed), cfg, dev,
                                        trainable=True)
        weights = list(model.parameters())
        B = tcfg.batch_size
        steps_per_epoch = max(1, -(-len(train_ds) // B))
        opt = Optimizer("Adam", step_decay_schedule(
            tcfg.lr, steps_per_epoch, 2, 0.1), weights)
        plane, train_src, score_src = self._sources(train_ds, score_ds)
        c["mini_trainings"] += 1
        c["resident_trainings"] += plane is Resident

        gstep = 0
        for epoch in range(epoch_num):
            epoch_accs: list[float] = []
            for i, (batch, labels, _, _) in enumerate(
                    train_src.epoch(rng_np, B)):
                gen = (step_generator(seed + 7, gstep, dev)
                       if cfg.dropout_rate > 0 else None)
                loss = train_step(model, weights, opt, batch, labels,
                                  self.class_weights, tcfg.clip_grad, gen)
                gstep += 1
                c["train_rows"] += len(labels)
                if (i + 1) % step_interval == 0:
                    with torch.no_grad():
                        pred = torch.argmax(model(batch)[1], dim=1)
                    acc = M.accuracy(labels.cpu().numpy(),
                                     pred.cpu().numpy())
                    epoch_accs.append(acc)
                    c["accuracy_checks"] += 1
                    if verbose:
                        print("Epoch [{}/{}], Step [{}/{}], "
                              "TrainLoss: {:.4f}, Accuracy: {:.4f}".format(
                                  epoch + 1, epoch_num, i + 1,
                                  steps_per_epoch, float(loss), acc))
                        sys.stdout.flush()
            # reference early break: running train accuracy >= .95
            # (denoise.py:108)
            if epoch_accs and np.mean(epoch_accs) >= 0.95:
                break
        c["steps"] += gstep
        sync_device(dev)
        t1 = time.time()

        probs1 = []
        with torch.no_grad():
            for lo in range(0, len(score_ds), B):
                batch, _ = score_src.batch(slice(lo, lo + B))
                probs1.append(model(batch)[1][:, 1])
                c["score_tiles"] += 1
        out = (torch.cat(probs1).cpu().numpy() if probs1
               else np.empty(0, np.float32))
        c["train_seconds"] += t1 - t0
        c["score_seconds"] += time.time() - t1
        return out.astype(np.float32)


def denoise(args) -> str:
    """CLI entry mirroring reference denoise(args) (denoise.py:318).
    Returns the path of the final denoised training file."""
    total_start = time.time()
    refuse_launch("denoise")
    device = resolve_device(args.device)
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
    # the k-mer-balanced negative reselection draws with random.Random's
    # API (rng.sample), seeded from the same stream
    py_rng = random.Random(int(rng.integers(1 << 62)))

    train_file = args.train_file
    # all-negative pool for k-mer-balanced reselection (denoise.py:296)
    fname, fext = os.path.splitext(train_file)
    train_neg_file = fname + ".neg_all." + modeltype_str + fext
    filter_rows_by_label(train_file, train_neg_file, 0)

    trainer = CrossRankTrainer(model_cfg, train_cfg, device)
    launches0 = kernel_launches()
    final_file = train_file
    iterations_run = 0
    for iter_c in range(args.iterations):
        iterations_run += 1
        print("\n###### cross rank to clean samples, Iter: {} ######".format(
            iter_c + 1))
        ds = FeatureDataset.from_file(train_file, model_cfg.seq_len,
                                      model_cfg.signal_len)
        n = len(ds)
        half = n // 2
        score_sum = np.zeros(n, np.float64)
        score_cnt = np.zeros(n, np.int64)
        for r in range(args.rounds):
            print("##########Train Cross Rank, Iter {}, Round {}##########"
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

        if iter_c == 0 and args.fst_iter_prob:
            with open(args.train_file + ".probs_1stiter.txt", "w") as wf:
                for i in range(n):
                    wf.write("\t".join([str(i), str(mean_scores[i])]) + "\n")

        # ---- clean samples (denoise.py:216-293) ----
        print("\n###### clean the samples ######")
        labels = ds.labels
        pos_mask = labels == 1
        neg_mask = ~pos_mask
        keep_pos = pos_mask & (mean_scores >= args.score_cf)
        keep_neg = (neg_mask & (mean_scores < 1 - args.score_cf)
                    if is_filter_fn else np.zeros(n, bool))
        n_pos, n_neg = int(pos_mask.sum()), int(neg_mask.sum())
        print("There are {} positive, {} negative samples in total;".format(
            n_pos, n_neg))
        left_ratio = float(keep_pos.sum()) / n_pos if n_pos else 0.0
        left_ratio2 = float(keep_neg.sum()) / n_neg if n_neg else 0.0
        print("{} ({}) high quality positive samples left, "
              "{} ({}) high quality negative samples left".format(
                  int(keep_pos.sum()), round(left_ratio, 6),
                  int(keep_neg.sum()), round(left_ratio2, 6)))

        if train_file == args.train_file:
            stem = fname + "." + modeltype_str
        else:
            stem = os.path.splitext(train_file)[0]
        pos_file = stem + ".pos.cf" + str(args.score_cf) + fext
        neg_file = (stem + ".neg.cf" + str(args.score_cf) + fext
                    if is_filter_fn else None)
        _write_selected_rows(train_file, pos_file, keep_pos,
                             neg_file, keep_neg)
        if is_filter_fn:
            left_ratio = (left_ratio + left_ratio2) / 2

        # ---- rebuild train file (denoise.py:347-375) ----
        # the previous iteration's working file goes only after its
        # replacement exists: when this iteration keeps no positive, it is
        # the returned final_file
        prev_file = train_file
        print("\n#####concat denoised file#####")
        pos_num = int(keep_pos.sum())
        if pos_num > 0:
            nfname, nfext = os.path.splitext(train_neg_file)
            seled_neg = nfname + ".r" + str(pos_num) + nfext
            if neg_file is None:
                select_neg_rows_as_pos_kmer_dist(pos_file, train_neg_file,
                                                 seled_neg, rng=py_rng)
            else:
                neg_num = count_lines(neg_file)
                if pos_num <= neg_num:
                    select_neg_rows_as_pos_kmer_dist(pos_file, neg_file,
                                                     seled_neg, rng=py_rng)
                    os.remove(neg_file)
                else:
                    seled_neg = neg_file
            tag = ".denoise_fpnp" if is_filter_fn else ".denoise_fp"
            train_file = (os.path.splitext(args.train_file)[0] + "." +
                          modeltype_str + tag + str(iter_c + 1) + fext)
            shuffle_concat(pos_file, seled_neg, train_file, rng=rng)
            os.remove(seled_neg)
            final_file = train_file
            if prev_file != args.train_file:
                os.remove(prev_file)
        else:
            if neg_file is not None:
                os.remove(neg_file)
            print("WARNING: The denoise module denoised all samples in the "
                  "train_file!!!")
        os.remove(pos_file)
        print("#####concat denoised file, finished!#####")

        if left_ratio >= args.kept_ratio or pos_num == 0:
            break

    os.remove(train_neg_file)
    seconds = time.time() - total_start
    print("###### denoised file for training: {}".format(final_file))
    print("###### denoise totally costs {:.2f} seconds".format(seconds))
    if args.verbose_stages:
        c = trainer.counters
        print("[stages] " + json.dumps({
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "compute_dtype": model_cfg.compute_dtype,
            "recurrence": model_cfg.recurrence,
            "iterations_run": iterations_run, **c,
            "forward_tiles": c["accuracy_checks"] + c["score_tiles"],
            "kernel_launches": kernel_launches_since(launches0),
            "mini_trainings_per_s": (c["mini_trainings"] / seconds
                                     if seconds else 0.0),
            "samples_per_s": (c["train_rows"] / c["train_seconds"]
                              if c["train_seconds"] else 0.0),
            "seconds": seconds, "final_file": final_file}))
    return final_file


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
