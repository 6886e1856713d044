#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepsignal_plant_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, runs and
agrees with itself on the card.

    python3 chip_smoke.py          # from the repository root; one card

Phases, in order; any failure exits non-zero before the last line.
"K1's bfloat16 kernel" below is its wgmma kernel, which every layer of
the main paths takes: a main-path launch of any other kernel fails the
run.

1. the card: name and power limit (nvidia-smi), torch's device name;
2. every kernel of the main paths, built from csrc/ by nvcc (one nvcc
   per source, all started together), against its plain PyTorch version
   on the card at the main paths' shapes: the fused BiLSTM layer (K1) at
   call_mods' 4096-row tiles, its ragged neighbour and the 1,016-row
   tail, --device_batch 3477 (bfloat16), and at phase 8 denoise's
   signal_bilstm layers in 512-row tiles and ragged tails, in bfloat16
   (the wgmma kernel, which every one of those layers takes, and the
   mma.sync kernel called directly) and in float32 (for
   exact-parity runs) through the route each layer takes and through
   each route called directly (the narrow kernel, at every shape it has
   a plan for; the 3xTF32 projection kernel and the float32 recurrence;
   the in-loop kernel), the routes against each other, and the
   projection kernel alone; (2b) the
   trainable recurrence (K2, K3 and K4's recurrence on the cluster
   kernels of the card's plan in each dtype, logged with the occupancy
   query it read; K4's bitwise reproducible; K4's split-K dW_hh, bitwise
   reproducible and all zeros at T=1; and the streaming kernels the
   cluster kernels replace) at the training batch of 512 and 509, H 128
   and 256, float32 and bfloat16;
3. each kernel timed with CUDA events (median of reps after warm-up)
   and as device time (replays of a CUDA graph; a call that cannot be
   captured fails the run) beside its plain version, one PyTorch library
   call computing the same function or more (a yardstick the port never
   calls) and its bound: K1 per 4096-row forward tile and per tail tile
   (bfloat16: the wgmma and the mma.sync kernels in turns at every layer,
   two pairs each, beside the L2 bytes of weights each design reads; (3d)
   where build/parent holds the parent commit's tree (``git archive``),
   each bfloat16 layer at 4096 and 1,016 rows of that tree and of this one
   in turns, parent, this, this, parent, each a fresh process;
   float32: its routes in turns at every layer, three rounds each (the
   narrow, in-loop and split routes at the branches; split and in-loop
   at the comb layers), the narrow layers also at train's 512- and
   256-row tiles and denoise's signal_bilstm first layer at 512, 256
   and 93 rows, the split route with its recurrence on each of K1's
   float32 recurrence kernels, and the projection kernel and K1's
   recurrence on their own, the recurrence on its wgmma kernel and on
   the cluster kernel in turns, with the float32 tile on each), (3b) the
   recurrence kernels per launch and per train
   step at batch 512, the cluster kernels and the streaming kernels in
   turns (cluster, stream, stream, cluster), in bfloat16 and in float32
   (beside cuDNN's float32 LSTM and einsum); (3c) one whole train step
   at batch 512, in bfloat16 and in float32, through the train loop's
   step function: device time, host enqueue time, and a torch.profiler
   trace (device busy share, top kernels);
4. the main paths through the user's entry points, each a fresh process
   whose kernel launch counts start at 0 and which prints them
   (--verbose_stages): ``call_mods`` on a seeded ~17.4k-row features TSV
   of unrelated windows (13 bases a site) through the read-packed route
   with a seeded random full-width both_bilstm checkpoint (5 launches of
   K1's bfloat16 kernel per forward tile in every run, none of the
   float32 one; the same rows in float32 through the float32 kernel and
   the plain version must agree); (4b)
   ``train`` with its defaults (bfloat16, resident plane,
   dropout 0.5, Adam) on a seeded learnable 16,384-row TSV for 2 epochs:
   5 launches of K3, K4 and dW_hh per step (K3 and K4 on the cluster
   kernels), 5 of K1's bfloat16 kernel per evaluation tile, none of K2
   or of a streaming kernel, validation accuracy above its threshold,
   and the best checkpoint drives ``call_mods``; (4c) float32 training
   through the kernels (K3 and K4 on their float32 cluster kernels)
   against the plain version, 8 steps; (4d) inference with the fused path
   off, through K2: 5 launches per 4096- and 512-row tile (the cluster
   kernels of each dtype at 512 rows), logits against the K1 path; the
   float32 call_mods run launches K1's float32 kernels as the route and
   plan rules give each layer of each tile on this card, one route a
   layer; (4e)
   call_mods' engine in this
   process on 131,072 read-structured dense rows (~3.9 bases a site;
   call_mods_ab.rate_run: sites/s, every [stages] field, the card's busy
   share, K1's launches), its rows byte-identical to per-site windows
   parsed on the host and called by the same model;
5. the host paths around the engine: ``serve --once`` in a fresh process
   over a watched directory (phase 4's sparse TSV, a 32,768-row dense TSV
   and its .tsv.gz copy, a malformed .tsv, an .npz that is no feature
   container): each served output byte-identical to the call_mods CLI's
   on the same file, the malformed files marked .failed while the server
   goes on, K1's bfloat16 kernel launched 5 times per forward tile in
   the serving process; per request its sites/s beside the CLI's cold
   time; then ``call_freq`` in this process on a seeded 2,000,000-row
   call file (~250,000 sites of A. thaliana's 7 contigs) plus the served
   outputs, as tsv, bed sorted gzip, and two contigs sorted, each on the
   host and with --device_agg on the card, byte-identical in pairs,
   rows/s of each; and sort_segment_reduce alone on one 8 MiB block on
   the card (its transfers included) against np.unique on the host
   (torch.sort and index_add_ are library calls, not kernels of the
   port: the kernels line does not list them);
6. the fast5 paths, with the port's own HDF5 reader (no h5py): a seeded
   run of 1,024 single-read tombo fast5s of 5,000 bases (reads cut from
   5-20 kb), written by the port's writer; the reader timed alone
   (reads/s, MB/s); ``extract`` to a TSV at --nproc 4 and 1 (the same
   bytes, rows/s); ``call_mods`` straight on the fast5 directory (bf16,
   float16 wire, --nproc 4: 5 launches of K1's bfloat16 kernel per
   forward tile, rows equal, sorted, to call_mods on the extracted TSV,
   sites/s and stages); float32 on 64 of the reads (kernel rows equal
   to the TSV plane's; against the plain version within the phase 4
   gate); ``serve --once`` over one run-folder of those 64 reads (bytes
   = the CLI's, a .done marker); (6c) VBZ: ``libzstd.so.1`` loads (its
   ``ZSTD_versionNumber`` printed), twins of the first 256 reads written
   by the port's writer with Signal in chunks of 10,000 samples, VBZ
   (tests/torch_vbz.py, as MinKNOW writes it) and gzip, each read as the
   original; the reader's reads/s and MB/s on each (two passes in
   turns); ``extract --nproc 4`` on the VBZ twin writes the original's
   bytes; fused ``call_mods`` on the original and both twins in one
   process after a warm-up run on the original (rows equal, 5
   launches of K1's bfloat16 kernel per forward tile, sites/s and
   parse_wait_seconds); (6d) the fast5 feature fixtures committed in
   tests/data/fast5_features/ (one read of 2,000 bases, plain and once
   per HDF5 structure fast5 writers add: enumerations, a variable-length
   sequence, a committed datatype, soft and external links, LZF, N-bit,
   scale-offset and szip signals, a shared message table, a filtered
   heap), each read as the plain file field for field, the reader's
   reads/s on each (two passes in turns); ``extract --nproc 4`` and
   fused ``call_mods`` on the directory write every file's rows equal to
   the plain file's (5 launches of K1's bfloat16 kernel per forward
   tile);
7. the .npz planes, on the first 256 of those reads (~80k sites; bf16,
   float16 wire unless stated): ``extract --w_format npz|npz_wire|
   npz_packed`` (and TSV) at --nproc 4, rows/s each; ``call_mods`` on the
   TSV and on each directory (v1 per-site, v2 repacked, v3 packed), in
   one process: 5 launches of K1's bfloat16 kernel per forward tile,
   rows equal, sorted, to the TSV plane's, sites/s and wire bytes per
   site; ``--transfer_dtype int8`` on v3 and on the TSV (bytes per site
   against float16, agreement with float16 reported: random weights, no
   gate); ``--device_resident always`` on the TSV and on v3 (bytes = the
   streaming plane's, segments, the forward's device time); float32 on
   v3, kernel against plain within the phase 4 gate; ``--profile_dir`` on
   one v3 file (the Chrome trace names K1's kernel and the engine's
   stages); ``serve --once`` over one dropped v3 .npz (bytes = the CLI's,
   a .done marker); one epoch of ``train`` on the v1 directory (5
   launches of K3, K4 and dW_hh per step);
8. denoise, resume and the streaming dataset: ``denoise``, each a fresh
   CLI process, with its defaults (bf16, signal_bilstm at hidden 256,
   dropout 0.5; ``--iterations 2 --rounds 1 --epoch_num 2``, an accuracy
   check every 4 steps) on a seeded learnable 16,384-row TSV with 20% of
   its label-0 rows flipped to 1: 4 launches of K3, K4 and dW_hh per step
   and of K1's bfloat16 kernel per forward tile (accuracy checks and
   scoring), label-1 purity against the true labels rising, wall time
   and mini-trainings/s; the same denoise in float32 at dropout 0
   through the kernels and through the plain versions (the same final
   file, the first iteration's mean scores within 1e-3); ``train`` for
   one epoch on phase 4b's rows, then ``--resume`` to two (it starts at
   epoch 2 and step 32, in a fresh process that reads the state file),
   and one epoch with ``--stream yes`` (in turn in the first run's
   process; each run's launches its own): 5 launches of K3, K4 and
   dW_hh per step, samples/s of each plane;
   (8b) ``denoise`` at two ranks on card 0 over gloo, one launch: the
   global-batch plane in float32 at dropout 0 on the first 8,192 rows of
   that TSV (``--iterations 1 --rounds 1 --epoch_num 2``; its final file
   equal to one process's at the same batch of 512, the first
   iteration's mean scores within 1e-5) and the sharded-resident plane
   at the CLI's defaults with DSP_DENOISE_RESIDENT_MIN_ROWS=0 on all of
   it with phase 8's arguments (label-1 purity at least 99%), each rank's launches against its
   steps and forward tiles, files from rank 0 only, the same halves
   drawn on every rank; one NCCL rank under ``torch.distributed.run``
   writing one process's file byte for byte; wall seconds and
   mini-trainings/s of each; and ResNet3 (models/resnet1d.py, no kernel)
   at the reference's widths on a (4096, 1, 16) input, the card against
   the CPU in training mode (outputs, running statistics) and eval mode
   with TF32 off, within 1e-4, and with TF32 on reported beside;
9. the spill plane and multi-process runs: (9a) ``train`` on phase 4b's
   rows (first 1,024 validation rows) with DSP_RESIDENT_MAX_BYTES set so
   the plane spills in 4 slabs, on the float16 and the int8 wire (5
   launches of K3, K4 and dW_hh a step, valid accuracy within 0.05 of
   phase 4b's, samples/s beside the resident plane's, upload seconds
   against step seconds); (9b) two ranks on card 0 over gloo (NCCL puts
   no two ranks on one card), one launch running four commands in turn:
   one epoch of ``train`` (256 rows a rank a step; phases 2 and 2b hold
   K1-K4 and dW_hh against their plain versions at that batch) on the
   sharded-resident and the host-fed plane (parameters bitwise equal
   across ranks, files from rank 0 only, the launches of each rank),
   fused ``call_mods`` on phase 6's 64 reads (the ranks' ``.host<N>``
   files hold one process's rows) and pod ``call_freq --device_agg`` on
   them (one process's bytes); (9c) under ``torch.distributed.run
   --nproc_per_node 1``, a one-rank NCCL group started by the port's
   ``parallel.dist.start_group``: the train step and evaluation through
   it bitwise those without it, a padded and masked step's update
   against the step on the rows kept, the port's collectives, then
   ``train`` in the group (every step and evaluation all-reducing over
   NCCL);
10. call_mods over a process's local cards: the CLI's default
   ``--device`` resolved (every visible card), then the engine over two
   replicas on card 0 (``[cuda:0, cuda:0]``: each batch cut into two
   contiguous shares, each share uploaded, forwarded and read back on
   its replica) against one replica, in turns (one, two, two, one), on
   phase 4e's dense 131,072 rows and on phase 7's v3 directory at
   ``--transfer_dtype int8`` (scales the batch's, sent to every share):
   the rows byte for byte the one replica's, K1's bfloat16 kernel 5
   times per forward tile of each share, sites/s, wire bytes a site and
   each replica's forward device seconds; with two or more
   visible cards, the CLI over every card against ``--device cuda:0`` on
   the dense rows. Two replicas on one card measure the split and the
   merge, not what N cards give. (10b) the engine on one card through
   each of K1's bfloat16 kernels in turns, on the dense TSV, v3 at int8
   and v3 at int8 resident: sites/s and the forwards' device seconds;
11. train and denoise over a process's local cards, and the host
   allocator: (11a) ``train_loop`` over ``[cuda:0, cuda:0]``, then over
   ``[cuda:0]``, one epoch of phase 4b's rows with phase 9b's arguments,
   on the sharded-resident and the host-fed plane: 5 launches of K3, K4
   and dW_hh a step on each replica, the two replicas' parameters
   bitwise equal, on the sharded plane the two-replica weights within
   2e-5 of phase 9b's two gloo ranks (bitwise expected), samples/s of
   each run; (11b) one 512-row step over one and over two replicas in
   turns, host enqueue and device ms; (11c) ``denoise`` over two
   replicas on card 0 on each of phase 8b's planes with 8b's arguments,
   its final file byte for byte 8b's two-rank file (on the global-batch
   plane, the layout of train's host-fed replicas); (11d)
   ``call_mods_ab.py`` on phase 4e's dense TSV and phase 4's sparse TSV
   four times over, with the host-allocator tune, then without it
   (glibc's own thresholds), a fresh process each: the rows byte for
   byte equal, sites/s, the parse stages and the card's busy share. Two
   replicas on one card measure the sums and the replica count's cost,
   not N cards;
12. a ``{"kernels": [...]}`` line (phase 6c's, 6d's, 8's, 8b's, 9's,
   10's and 11's launches beside each kernel's main-path count), the card line,
   and last ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package. Without a card, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T = 13
TILE = 4096
N_ROWS = 17_400            # four full 4096-row forward tiles + a ragged tail
TAIL = N_ROWS % TILE       # of 1,016 rows
SEED = 20261016
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores,
# float32 on the CUDA cores, and the HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# TF32 on the tensor cores: the float32 cluster kernels run each f32
# product as three (3xTF32), so their product bound is 3x the products at
# this rate (165 TFLOP/s of f32 products)
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
# K1 at bfloat16: the wgmma kernel, which every main-path and denoise
# layer takes (ops/fused_lstm.py::k1_bf16_plan; phase 2 asserts it), and
# the mma.sync kernel, which takes the shapes the wgmma kernel does
# not fit (H > 256, inputs too wide for its shared memory) and is timed
# beside it (ops/fused_lstm.py's counters)
K1_BF16 = "fused_bilstm_bf16_wgmma"
K1_BF16_MMA = "fused_bilstm_bf16"
# K1 in each compute dtype: bfloat16 its kernels; float32 the layer
# through the route it takes ("k1_float32" is a route of two or one
# launches, not a kernel: the kernels line lists its kernels,
# K1_F32_KERNELS)
K1_KERNELS = {K1_BF16: "bfloat16", "k1_float32": "float32"}
# K1's routes (bf16: the kernel k1_bf16_plan picks, "mma" the mma.sync
# kernel called directly; float32: "narrow", the narrow kernel; "inloop",
# the in-loop kernel) -> the key their errors go under; the split route
# (the projection kernel and the recurrence) goes under its recurrence
# kernel's counter (route_key)
K1_ROUTE_KEYS = {"bf16": K1_BF16, "mma": K1_BF16_MMA,
                 "narrow": "fused_bilstm_f32_narrow",
                 "inloop": "fused_bilstm_f32_inloop"}
K1_F32_KERNELS = ("fused_bilstm_proj_f32", "fused_bilstm_rec_f32_wgmma",
                  "fused_bilstm_rec_f32", "fused_bilstm_f32_narrow",
                  "fused_bilstm_f32_inloop")
# the counter of each kernel of K1's float32 recurrence, by the kind
# recurrence.k1_rec_plan gives
K1_REC_COUNTERS = {"wgmma": "fused_bilstm_rec_f32_wgmma",
                   "cluster": "fused_bilstm_rec_f32",
                   "stream": "fused_bilstm_rec_f32_stream"}
# each float32 K1 layer launches exactly one of these, whatever its route
# (ops/fused_lstm.py's launches): their sum is a run's layer count
K1_F32_LAYER_KERNELS = ("fused_bilstm_f32_narrow", "fused_bilstm_f32_inloop",
                        "fused_bilstm_proj_f32")
K1_ERR_KEYS = (K1_BF16, K1_BF16_MMA, "k1_float32") + K1_F32_KERNELS
# the bf16 kernels timed in turns (mma, wgmma, wgmma, mma) this many times
# per layer and batch
K1_BF16_PAIRS = 2
# K1's float32 routes timed in turns (narrow, in-loop, split, split,
# in-loop, narrow; the comb layers, which have no narrow plan: split,
# in-loop, in-loop, split) this many times per layer and batch, to show
# their spread
K1_F32_PAIRS = 3
# the narrow layers' other batches (train's evaluation tile and a
# two-rank share of it) and denoise's signal_bilstm first layer at its
# tiles, timed through the three routes as phase 3 times the main path's:
# the route rule takes the narrow kernel only where it was the fastest
NARROW_EXTRA_TIMED = ((7, 0, 128, (512, 256)), (16, 0, 128, (512, 256)),
                      (16, 0, 256, (512, 256, 93)))
# a --device_batch that is no multiple of 64 (one forward tile of 3,477
# rows: clusters of 4 over 55 row tiles, the last ragged), checked at
# bfloat16
DEVICE_BATCH_ODD = 3477
# (Fa, Fb, H, seq_out) of the five layer launches of one forward tile
MAIN_PATH_LAYERS = {
    "seq": (7, 0, 128, True),
    "signal": (16, 0, 128, True),
    "comb0": (128, 128, 256, True),
    "comb1": (256, 256, 256, True),
    "comb2": (256, 256, 256, False),
}
# kernel vs plain, both on the card. float32: the two sum up to 768
# products per gate in different orders, compounded over 13 steps.
# bfloat16: both round h to bf16 every step (ulp 2^-8 just below 1); a
# sum on the other side of a rounding boundary moves h by an ulp, and the
# following steps carry it on.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# call_mods rows, float32 kernel vs float32 plain: 6-decimal output
# rounding (5e-7) plus the layer differences above carried to P1
P1_TOL_F32 = 1e-5

# the training path: batch 512; (F, H) of the five BiLSTM layers of one
# train step. The recurrence kernels see only H (xproj is (T, 2, B, 4H)).
TRAIN_B = 512
TRAIN_LAYERS = {"seq": (7, 128), "signal": (16, 128), "comb0": (256, 256),
                "comb1": (512, 256), "comb2": (512, 256)}
REC_KERNELS = {   # wrapper -> the TPU kernel it replaces
    "lstm_recurrence_fwd": "deepsignal_plant_tpu/ops/pallas_lstm.py:57",
    "lstm_recurrence_fwd_save": "deepsignal_plant_tpu/ops/pallas_lstm.py:131",
    "lstm_recurrence_bwd": "deepsignal_plant_tpu/ops/pallas_lstm.py:159",
    "lstm_dw_hh": "deepsignal_plant_tpu/ops/pallas_lstm.py:159",
}
# the float32 cluster kernels (their launch counters) -> the wrapper
F32_KERNELS = {"lstm_recurrence_fwd_f32": "lstm_recurrence_fwd",
               "lstm_recurrence_fwd_save_f32": "lstm_recurrence_fwd_save",
               "lstm_recurrence_bwd_f32": "lstm_recurrence_bwd"}
# recurrence kernels vs plain, times max(1, max |plain|). float32 as for
# K1, and the cluster kernels' 3xTF32 products also drop each product's
# lo*lo term (about 2^-22 of it). bfloat16: as for K1 for h, and for
# dxproj because da is rounded to
# bf16 before it feeds the next step's dh, so one flipped rounding travels
# back through the steps. dW_hh gets identical inputs on both sides and
# differs only in the order of its f32 sums over (T-1)*B rows.
REC_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DW_TOL = 1e-5
# train data: labels shift the means and signals by +-TRAIN_SHIFT under
# N(0, 0.3) and N(0, 0.5) noise: the mean of a row's 13 x 16 signal
# alone separates the labels by 11 standard deviations, but the model
# starts at chance and has to learn it; 2 epochs of Adam must reach
TRAIN_ROWS, VALID_ROWS, TRAIN_SHIFT = 16_384, 4_096, 0.2
TRAIN_ACC_MIN = 0.9
# 4c: float32 kernel vs float32 plain training, 8 SGD steps (lr 0.1):
# per-step losses and final parameters; the kernels' float32 sums differ
# from the plain version's in order (2e-5 per layer, above) and in the
# 3xTF32 products' dropped lo*lo terms, and 8 clipped steps carry that
# into the weights
F32_TRAIN_STEPS = 8
F32_LOSS_TOL = 1e-4
F32_PARAM_TOL = 1e-4
# phase 4e, call_mods' rate run: a read-structured dense TSV (one site
# per C, ~3.9 bases a site) of RATE_ROWS rows, four 32768-site batches
# (so the pinned ring of 3 slots is reused)
RATE_ROWS = 131_072
# 4d: inference through K2 (fused path off) vs through K1, on one
# 4096-row tile of the trained model, times max(1, max |logit|): float32
# differs in summation order (and K2's cluster kernel in its 3xTF32
# products' dropped lo*lo terms); bfloat16 also rounds xproj to bf16 on
# the K2 path, where K1 keeps the input projection in f32
K2_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


# phase 5, serve: the watched directory holds phase 4's sparse TSV, one
# dense TSV of this many rows (call_mods_ab.write_dense_features), its
# .tsv.gz copy, one malformed .tsv and one .npz that is no feature
# container (both marked .failed)
SERVE_DENSE_ROWS = 32_768
# phase 5, call_freq: a plant sample's call_mods output holds tens of
# millions of rows; this one FREQ_ROWS rows over ~FREQ_SITES sites of A.
# thaliana's seven contigs (TAIR10 lengths), ~8 calls a site, in reads of
# READ_SITES consecutive sites
FREQ_ROWS = 2_000_000
FREQ_SITES = 250_000
READ_SITES = 40
TAIR10 = {"Chr1": 30_427_671, "Chr2": 19_698_289, "Chr3": 23_459_830,
          "Chr4": 18_585_056, "Chr5": 26_975_502, "ChrC": 154_478,
          "ChrM": 366_924}
# the call_freq runs, each on the host and with --device_agg on the card
FREQ_RUNS = {"tsv": [], "bed, sorted, gzip": ["--bed", "--sort", "--gzip"],
             "contigs Chr5,ChrC, sorted": ["--contigs", "Chr5,ChrC",
                                           "--sort", "--nproc", "1"]}
# phase 6, fast5: a seeded genome of 7 contigs (~2 Mb) and FAST5_READS
# single-read tombo fast5s of FAST5_READ_LEN bases, in the event-length
# and DAC model of tests/make_synthetic.py synth_fast5_dir (events of
# 3-20 samples, so bases longer than signal_len exercise the "even"
# downsampling; DAC integers 300-699; strands alternating). Real ONT
# reads run 5-20 kb; these are cut to 5 kb so the phase stays short.
FAST5_GENOME = {f"chr{i + 1}": n for i, n in enumerate(
    (420_000, 360_000, 330_000, 300_000, 290_000, 160_000, 140_000))}
FAST5_READS = 1024
FAST5_READ_LEN = 5_000
FAST5_MAX_EVENT = 21          # event lengths 3-20 (integers below this)
# the float32 comparison and the served run-folder use the first reads
FAST5_SUB_READS = 64
# phase 6c, VBZ: twins of phase 6's first VBZ_READS reads, Signal in
# chunks of VBZ_CHUNK samples (several a read, the last partial), once
# VBZ-encoded as MinKNOW writes it (tests/torch_vbz.py, client data
# values 0, 2, 1, 1) and once gzip (deflate level 4)
VBZ_READS = 256
VBZ_CHUNK = 10_000
# phase 6d, the fast5 feature fixtures committed in the repository
# (tests/data/fast5_features/, written by tests/make_fast5_features.py,
# which needs h5py): one tombo read of 2,000 bases stored plain and once
# per HDF5 structure fast5 writers add (enumerations, a variable-length
# sequence, a committed datatype, soft and external links, LZF, N-bit,
# scale-offset and szip signals, a shared message table, a filtered
# heap); each file's reader rate timed over FEATURE_READS reads, in two
# passes in turns
FEATURE_DIR = os.path.join(REPO, "tests", "data", "fast5_features")
FEATURE_READS = 25
# phase 7, the .npz planes: the first NPZ_READS reads of phase 6's run
# (~80k sites), extracted into each container at --nproc 4; the fast5
# batches of extract's default size (30 reads) give 9 files
NPZ_READS = 256
NPZ_FORMATS = {"npz": 0, "npz_wire": 2, "npz_packed": 3}
# phase 8, denoise: DENOISE_ROWS rows of phase 4b's writer with labels
# shifting the signals by +-DENOISE_SHIFT (signal_bilstm sees only the
# signals), DENOISE_FLIP of the label-0 rows flipped to 1 by a seed; the
# CLI's defaults (signal_bilstm, hidden 256: 1 signal-branch + 3 comb
# layers, so 4 launches of each training kernel a step and of K1 a
# forward tile) with --iterations 2 --rounds 1 --epoch_num 2, and an
# accuracy check every DENOISE_CHECK steps (the early stop's input)
DENOISE_ROWS, DENOISE_SHIFT, DENOISE_FLIP = 16_384, 0.8, 0.2
DENOISE_CHECK = 4
DENOISE_LAYERS = 4
# (Fa, Fb, H) of those layers' K1 launches (signal branch; comb layer 0,
# which reads the signal branch alone; comb layers 1-2), and the rows of
# denoise's forward tiles: --batch_size 512 and ragged epoch tails
DENOISE_K1_SHAPES = ((16, 0, 256), (256, 0, 256), (256, 256, 256))
# (and phase 8b's 256-row tiles of a rank: accuracy checks and scoring)
DENOISE_TILES = (512, 509, 93, 256)
DENOISE_ARGS = ("--iterations", "2", "--rounds", "1", "--epoch_num", "2",
                "--step_interval", str(DENOISE_CHECK), "--seed", "77")
# float32 denoise, kernels against the plain versions at dropout 0: the
# first iteration's mean scores (2 x 16 steps of training apart, each
# step's float32 sums in other orders) and the rows kept
DENOISE_SCORE_TOL = 1e-3
# phase 8b, denoise at RANKS ranks on card 0 over gloo. The global-batch
# plane on the first DENOISE_RANK_ROWS rows of phase 8's noisy TSV, one
# iteration, one round, 2 epochs (at most 16 steps a mini-training at the
# global batch of 512, 256 a rank), in float32 at dropout 0, against one
# process at batch 512: the ranks' 256-row shares sum their gradients in
# another order than one 512-row batch, and K1 scores 256-row tiles where
# one process scores 512, so the mean scores differ by float32 rounding
# carried through up to 32 Adam steps. The sharded-resident plane
# (DSP_DENOISE_RESIDENT_MIN_ROWS=0) at the CLI's defaults on all of phase
# 8's TSV with phase 8's arguments, beside phase 8's one-process run,
# must reach DENOISE_PURITY label-1 purity.
DENOISE_RANK_ROWS = 8_192
DENOISE_RANK_ARGS = ("--iterations", "1", "--rounds", "1", "--epoch_num",
                     "2", "--step_interval", str(DENOISE_CHECK), "--seed",
                     "77")
DENOISE_RANK_SCORE_TOL = 1e-5
DENOISE_PURITY = 0.99
# phase 8b, ResNet3 (models/resnet1d.py, no kernel: cuDNN convolutions):
# the reference's widths on a (4096, 1, 16) input, the card against the
# CPU at float32 with TF32 off; both sum each output's 3 x C_in products
# (at most 192) in their own order, and training mode's batch statistics
# over 4096 x L values
RESNET_BATCH, RESNET_LEN, RESNET_OUT, RESNET_TOL = 4096, 16, 128, 1e-4
# phase 9a, the spill plane: phase 4b's 16,384 training rows against the
# first SPILL_VALID_ROWS of its validation rows, with DSP_RESIDENT_MAX_BYTES
# set per wire so that the rows go up in slabs of SPILL_SLAB_ROWS (4
# slabs); a FeatureDataset row on the host is T int32 codes, 3 x T float32
# features, T x 16 float32 signals and an int32 label; a row on the wire
# is the spill plane's bytes_per_row
SPILL_VALID_ROWS, SPILL_SLAB_ROWS = 1_024, 4_096
HOST_ROW_BYTES = T * (4 + 3 * 4 + 16 * 4) + 4
WIRE_ROW_BYTES = {"float16": T * (1 + 2 + 2 + 2 + 2 * 16) + 1,
                  "int8": T * (1 + 1 + 1 + 2 + 16) + 1}
# the spill runs' best valid accuracy against the resident run's (phase
# 4b, all VALID_ROWS)
SPILL_ACC_TOL = 0.05
# phase 9b: two ranks on one card over gloo (NCCL refuses two ranks on
# one card), one epoch of phase 4b's rows a plane at the global batch of
# TRAIN_B (TRAIN_B / 2 a rank)
RANKS = 2
# phase 11: two replicas on card 0 against two gloo ranks on the same rows
# and seed (phase 9b); the same float32 adds in the same order, so
# bitwise is expected
TRAIN_RANKS_TOL = 2e-5
# phase 9c: the step on a rank's rows with the last eighth padded and
# masked against the step on the rows kept, in bfloat16 (SGD's first
# update is the clipped gradient): max|difference| over max|update|
NCCL_UPDATE_TOL = 1e-2
# the [stages] fields of call_mods that say where its time goes
STAGE_FIELDS = ("batches", "packed_batches", "packed_sites",
                "persite_batches", "persite_sites", "bases_uploaded",
                "wire_bytes", "parse_seconds",
                "parse_wait_seconds", "batch_seconds", "upload_seconds",
                "forward_seconds", "readback_seconds", "format_seconds",
                "drain_seconds", "unfed_seconds", "upload_device_seconds",
                "forward_device_seconds", "seconds")


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


T0 = time.time()


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.time() - T0:.1f} s] {msg}", flush=True)


def layer_inputs(torch, Fa, Fb, H, B, dtype, seed=SEED):
    """Seeded inputs: raw features ~ N(0,1) for the branch layers, U(-1,1)
    for the comb layers (previous layers' h); torch's LSTM init for the
    weights, a sum of two draws for the folded bias."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    xs = [rng.normal(size=(T, B, F)) if Fb == 0 else
          rng.uniform(-1, 1, (T, B, F)) for F in ((Fa, Fb) if Fb else (Fa,))]
    w_ih = rng.uniform(-k, k, (2, Fa + Fb, 4 * H))
    w_hh = rng.uniform(-k, k, (2, H, 4 * H))
    b = rng.uniform(-k, k, (2, 4 * H)) + rng.uniform(-k, k, (2, 4 * H))

    def dev(a, dt):
        return torch.tensor(a, dtype=torch.float32).to("cuda", dt)

    return (tuple(dev(x, dtype) for x in xs), dev(w_ih, dtype),
            dev(b, torch.float32), dev(w_hh, dtype))


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds of one call: ``reps`` calls captured in one
    CUDA graph, its replays timed with CUDA events (median of 5) over
    ``reps``, so the host's time to issue a call does not count. A call
    that cannot be captured fails the run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        fail(f"CUDA graph capture failed: {exc}")
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def layer_bound(Fa, Fb, H, seq_out, B, itemsize, peak_flops, passes=1):
    """(ms at the peak operation rate, ms at the memory rate) of one
    layer: its products (each run ``passes`` times: 3 for 3xTF32), and
    its compulsory bytes (each input read once, each output written
    once). The bound is the larger."""
    F = Fa + Fb
    flops = 2 * 2 * T * B * (F + H) * 4 * H
    out_T = T if seq_out else 1
    nbytes = (T * B * F * itemsize + 2 * (F + H) * 4 * H * itemsize
              + 2 * 4 * H * 4 + 2 * out_T * B * H * itemsize)
    return flops * passes / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3


def k1_moves(fused_lstm, route, plan):
    """The counters one K1 layer moves: bfloat16 its kernel; float32
    the narrow kernel, the in-loop kernel, or the projection kernel and
    the recurrence kernel of the plan (k1_plan: K1's wgmma recurrence,
    the cluster kernel or the streaming kernel)."""
    want = {k: 0 for k in fused_lstm.launches}
    if route in ("bf16", "mma", "narrow", "inloop"):
        want[K1_ROUTE_KEYS[route]] = 1
    else:
        want["fused_bilstm_proj_f32"] = 1
        want[K1_REC_COUNTERS[plan[0]]] = 1
    return want


def route_key(route, plan):
    """The key a K1 route's errors go under: the split route's, its
    recurrence kernel's counter (k1_plan's kind)."""
    return K1_REC_COUNTERS[plan[0]] if route == "split" else \
        K1_ROUTE_KEYS[route]


def k1_plan(torch, recurrence, B, H):
    """K1's recurrence plan on card 0: recurrence.k1_rec_plan's (kind,
    plan)."""
    return recurrence.k1_rec_plan_on(torch.device("cuda", 0), B, H)


def f32_routes(fused_lstm):
    """K1's float32 routes, called directly."""
    return {"narrow": fused_lstm.layer_f32_narrow,
            "split": fused_lstm.layer_f32_split,
            "inloop": fused_lstm.layer_f32_inloop}


def k1_f32_layers(kl: dict) -> int:
    """K1 float32 layers a run launched: one of K1_F32_LAYER_KERNELS
    each."""
    return sum(kl[k] for k in K1_F32_LAYER_KERNELS)


def k1_routes(fused_lstm):
    """K1's routes called directly: float32's three and the bf16 mma.sync
    kernel."""
    return {**f32_routes(fused_lstm), "mma": fused_lstm.layer_bf16_mma}


def f32_route(torch, fused_lstm, F, H, B):
    """The float32 route bilstm_layer_fused takes on card 0."""
    return fused_lstm.f32_route_on(torch.device("cuda", 0), F, H, B)[0]


def narrow_plan(torch, fused_lstm, F, H, B):
    """The narrow kernel's plan on card 0 (None where it has none)."""
    return fused_lstm.narrow_plan_on(torch.device("cuda", 0), F, H, B)


def check_kernel(torch, fused_lstm, recurrence, plain):
    """Phase 2: K1 against the plain version at every layer shape of the
    main path (full, ragged and tail 4096-row tiles; the 512-row tiles
    of training's evaluations and the 256-row tiles of a rank's in phase
    9b's) and of phase 8's denoise (signal_bilstm's layers in 512-row
    tiles and their tails),
    seq_out True and False: the bfloat16 kernel, and float32 through the
    route it takes and through each of its routes called directly (the
    projection kernel and the recurrence; the in-loop kernel; the narrow
    kernel, at every shape it has a plan for), which are also held
    against each other (the narrow kernel against the other two); the
    float32 projection kernel alone against its plain version. Each
    launch must move the counters of the kernels named."""
    cases = [(shape, (TILE, TILE - 3, TAIL, TRAIN_B, TRAIN_B // RANKS,
                      DEVICE_BATCH_ODD))
             for shape in sorted(
        {(Fa, Fb, H) for Fa, Fb, H, _ in MAIN_PATH_LAYERS.values()})]
    cases += [(shape, DENOISE_TILES) for shape in DENOISE_K1_SHAPES]
    errs = {k: 0.0 for k in K1_ERR_KEYS}
    checked = []
    for (Fa, Fb, H), tiles in cases:
        for B in tiles:
            for dname in ("bfloat16", "float32"):
                if dname == "float32" and B == DEVICE_BATCH_ODD:
                    continue            # the default dtype's batch only
                dtype = getattr(torch, dname)
                xs, w_ih, b, w_hh = layer_inputs(torch, Fa, Fb, H, B, dtype)
                if dtype == torch.float32:
                    want_x = plain.input_projection(xs, w_ih, b)
                    got_x = fused_lstm.input_projection(xs, w_ih, b)
                    torch.cuda.synchronize()
                    err = (got_x - want_x).abs().max().item()
                    log(f"fused_bilstm_proj_f32 F=({Fa},{Fb}) H={H} B={B}: "
                        f"max|kernel-plain| = {err:.3g} (tolerance "
                        f"{TOL[dname]:g} x max(1, {want_x.abs().max():.3g}))")
                    if err > TOL[dname] * max(1.0, want_x.abs().max().item()):
                        fail("the projection kernel disagrees with its plain "
                             f"version by {err}")
                    errs["fused_bilstm_proj_f32"] = max(
                        errs["fused_bilstm_proj_f32"], err)
                    checked.append([Fa, Fb, H, B, "fused_bilstm_proj_f32"])
                    del got_x, want_x
                plan = (k1_plan(torch, recurrence, B, H)
                        if dtype == torch.float32 else None)
                auto = (f32_route(torch, fused_lstm, Fa + Fb, H, B)
                        if dtype == torch.float32 else "bf16")
                if dtype == torch.bfloat16 and fused_lstm.k1_bf16_plan(
                        Fa + Fb, H, B) is None:
                    fail(f"K1 bf16 F=({Fa},{Fb}) H={H} B={B} would not take "
                         f"the wgmma kernel")
                routes = (("bf16", None), ("mma", "mma")) \
                    if dtype == torch.bfloat16 else (
                    (auto, None), ("split", "split"), ("inloop", "inloop"))
                if dtype == torch.float32 and narrow_plan(
                        torch, fused_lstm, Fa + Fb, H, B) is not None:
                    routes += (("narrow", "narrow"),)
                for seq_out in (True, False):
                    want = plain.bilstm_layer(xs, w_ih, b, w_hh, H, seq_out)
                    outs = {}
                    for route, force in routes:
                        before = dict(fused_lstm.launches)
                        layer = (k1_routes(fused_lstm)[force] if force
                                 else fused_lstm.bilstm_layer_fused)
                        got = layer(xs, w_ih, b, w_hh, H, seq_out)
                        torch.cuda.synchronize()
                        moved = {k: v - before[k]
                                 for k, v in fused_lstm.launches.items()}
                        expect = k1_moves(fused_lstm, route, plan)
                        if moved != expect:
                            fail(f"K1 {dname} route {route} F=({Fa},{Fb}) "
                                 f"H={H} B={B}: launches {moved}, expected "
                                 f"{expect}")
                        out_T = T if seq_out else 1
                        err = 0.0
                        for g, w in zip(got, want):
                            if g.shape != (out_T, B, H) or g.dtype != dtype:
                                fail(f"kernel output {tuple(g.shape)} "
                                     f"{g.dtype}")
                            if not torch.isfinite(g.float()).all():
                                fail("kernel output is not finite")
                            err = max(err, (g.float() - w.float()).abs()
                                      .max().item())
                        key = route_key(route, plan)
                        taken = force is None and dtype == torch.float32
                        log(f"{key} F=({Fa},{Fb}) H={H} B={B} "
                            f"seq_out={seq_out}{' (taken)' * taken}: "
                            f"max|kernel-plain| = {err:.3g} (tolerance "
                            f"{TOL[dname]:g})")
                        if err > TOL[dname]:
                            fail(f"{key} disagrees with its plain version "
                                 f"by {err} > {TOL[dname]}")
                        errs[key] = max(errs[key], err)
                        if taken:
                            errs["k1_float32"] = max(errs["k1_float32"], err)
                        outs[route] = got
                        checked.append([Fa, Fb, H, B, "k1_float32"
                                        if taken else key, seq_out])
                    if dtype == torch.float32:
                        f32_pairs = [("split", "inloop")] + [
                            ("narrow", r) for r in ("split", "inloop")
                            if "narrow" in outs]
                        for r1, r2 in f32_pairs:
                            err = max((a - c).abs().max().item()
                                      for a, c in zip(outs[r1], outs[r2]))
                            log(f"float32 K1 routes against each other F=("
                                f"{Fa},{Fb}) H={H} B={B} seq_out={seq_out}: "
                                f"max|{r1} - {r2}| = {err:.3g}")
                            if err > TOL[dname]:
                                fail(f"K1's float32 routes {r1} and {r2} "
                                     f"disagree by {err}")
    return errs, checked


def proj_bound(Fa, Fb, H, B):
    """(ms at the peak operation rate, ms at the memory rate) of the
    float32 projection kernel's work: its f32 products in 3xTF32, and x,
    W_ih and the bias read once, xproj (T, 2, B, 4H) written once."""
    F = Fa + Fb
    flops = 2 * 2 * T * B * F * 4 * H * TF32_PASSES
    nbytes = 4 * (T * B * F + 2 * F * 4 * H + 2 * 4 * H + T * 2 * B * 4 * H)
    return flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def split_packed(fused_lstm, w_ih, w_hh, Fa):
    """The split route's packed weights, as a model caches them: the
    projection's planes at this row split and K1's wgmma recurrence's
    (None at the widths it does not take)."""
    from deepsignal_plant_tpu_torch.ops import recurrence
    H = w_hh.shape[1]
    return (fused_lstm.pack_proj_weights(w_ih, Fa),
            fused_lstm.pack_rec_weights(w_hh)
            if H in recurrence.K1W_WIDTHS else None)


def f32_turns(torch, fused_lstm, Fa, Fb, H, seq_out, x, w_ih, b, w_hh,
              packed) -> dict:
    """K1's float32 routes on one layer in turns, K1_F32_PAIRS times
    (narrow, in-loop, split, split, in-loop, narrow where the narrow kernel
    has a plan; split, in-loop, in-loop, split elsewhere; graph replays,
    each route over its weights packed beforehand, as a model caches
    them), and beside the split route, at the widths K1's wgmma
    recurrence takes, the split route on each recurrence kernel
    (recurrence.force_k1_rec: "split_wgmma", "split_cluster", in turns
    after it): each route's times and mean, the route the rule takes,
    the route the narrow kernel replaces (the rule's choice without it),
    the fastest of the three routes, and the pairwise differences in the
    order timed."""
    B = x[0].shape[1]
    from deepsignal_plant_tpu_torch.ops import recurrence as rec
    routes = f32_routes(fused_lstm)
    plan = narrow_plan(torch, fused_lstm, Fa + Fb, H, B)
    forced = ("split_wgmma", "split_cluster") if H in rec.K1W_WIDTHS else ()
    order = (("narrow", "inloop", "split", *forced, *forced[::-1], "split",
              "inloop", "narrow")
             if plan else ("split", *forced, "inloop", "inloop",
                           *forced[::-1], "split"))

    def call(r):
        if r == "inloop":
            return lambda: routes[r](x, w_ih, b, w_hh, H, seq_out)
        if r in forced:
            def run():
                with rec.force_k1_rec(r.split("_")[1]):
                    return routes["split"](x, w_ih, b, w_hh, H, seq_out,
                                           packed=packed["split"])
            return run
        return lambda: routes[r](x, w_ih, b, w_hh, H, seq_out,
                                 packed=packed[r])

    runs = {r: [] for r in order}
    for _ in range(K1_F32_PAIRS):
        for r in order:
            runs[r].append(graph_ms(torch, call(r), reps=10))
    means = {r: statistics.mean(v) for r, v in runs.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"route": f32_route(torch, fused_lstm, Fa + Fb, H, B),
           "replaced_route": fused_lstm.f32_route(Fa + Fb, H, B, sms, None),
           "fastest": min((r for r in means if r not in forced),
                          key=means.get), "narrow_plan": plan,
           **{f"{r}_ms_runs": v for r, v in runs.items()},
           **{f"{r}_ms": m for r, m in means.items()},
           # in-loop minus split, pair by pair in the order timed
           "inloop_minus_split_ms": [
               i - s_ for i, s_ in zip(runs["inloop"], runs["split"])]}
    if plan:
        out["narrow_kernel_ms"] = cuda_ms(torch, call("narrow"))
        for r in ("inloop", "split"):
            out[f"narrow_minus_{r}_ms"] = [
                n - o for n, o in zip(runs["narrow"], runs[r])]
        out["narrow_faster"] = means["narrow"] < means[out["replaced_route"]]
    out["device_ms"] = means[out["route"]]
    return out


def time_k1_f32(torch, fused_lstm, recurrence, plain, Fa, Fb, H, seq_out,
                xs, w_ih, b, w_hh, packed):
    """Phase 3, K1 at float32, one main-path layer at B=4096 and at the
    TAIL rows: its routes in turns (f32_turns), the route it takes, and
    the split route's parts: the projection kernel (beside its plain
    version, one torch.matmul and its bound) and the recurrence on its
    plan (beside its plain version and its bound), and at the widths K1's
    wgmma recurrence takes, the recurrence on each of its kernels in
    turns (wgmma, cluster, cluster, wgmma, K1_F32_PAIRS times;
    recurrence.force_k1_rec). ``packed``: the narrow and split routes'
    packed weights."""
    out = {}
    for B in (TILE, TAIL):
        x = tuple(v[:, :B].contiguous() for v in xs)
        pre = "" if B == TILE else "tail_"
        row = f32_turns(torch, fused_lstm, Fa, Fb, H, seq_out, x, w_ih, b,
                        w_hh, packed)
        taken = row["route"]
        xproj = fused_lstm.input_projection(x, w_ih, b, packed["split"][0])
        x2d = torch.cat(x, dim=-1).reshape(T * B, Fa + Fb)
        pj_ops, pj_bytes = proj_bound(Fa, Fb, H, B)
        rc_ops, rc_bytes = rec_bound("lstm_recurrence_fwd", H, B, 4,
                                     PEAK_TF32_FLOPS, TF32_PASSES)
        row.update({
            "kernel_ms": cuda_ms(torch, lambda: fused_lstm.bilstm_layer_fused(
                x, w_ih, b, w_hh, H, seq_out, packed=packed.get(taken))),
            "proj_ms": graph_ms(torch, lambda: fused_lstm.input_projection(
                x, w_ih, b, packed["split"][0]), reps=10),
            "proj_plain_ms": cuda_ms(torch, lambda: plain.input_projection(
                x, w_ih, b), reps=10),
            # one library call of the same product (no bias, no flip):
            # x (T*B, F) @ w_ih (2, F, 4H), float32 cuBLAS, TF32 off
            "proj_library_ms": graph_ms(torch, lambda: torch.matmul(
                x2d, w_ih), reps=10),
            "proj_bound_ms": max(pj_ops, pj_bytes),
            "proj_bound_by": "operations" if pj_ops >= pj_bytes else "bytes",
            "rec_plan": k1_plan(torch, recurrence, B, H),
            "rec_ms": graph_ms(torch, lambda: recurrence.lstm_recurrence_k1(
                xproj, w_hh, H, seq_out, fused_lstm.launches,
                packed["split"][1]), reps=10),
            "rec_plain_ms": cuda_ms(torch, lambda: plain.k1_outputs(
                plain.lstm_recurrence(xproj, w_hh, H), seq_out), reps=5),
            "rec_bound_ms": max(rc_ops, rc_bytes),
            "rec_bound_by": "operations" if rc_ops >= rc_bytes else "bytes"})
        if H in recurrence.K1W_WIDTHS:
            row.update(rec_turns(torch, fused_lstm, recurrence, xproj, w_hh,
                                 H, seq_out, packed["split"][1]))
        out.update({pre + k: v for k, v in row.items()})
        log(f"K1 float32, F=({Fa},{Fb}) H={H} B={B}: route {taken}, in "
            f"turns " + ", ".join(f"{r} {row[r + '_ms']:.4f}" for r in (
                *f32_routes(fused_lstm), "split_wgmma", "split_cluster",
                "rec_wgmma", "rec_cluster") if r + "_ms" in row))
        del x, xproj, x2d
    out["tail_B"] = TAIL
    return out


def rec_turns(torch, fused_lstm, recurrence, xproj, w_hh, H, seq_out,
              packed) -> dict:
    """K1's float32 recurrence on each of its kernels in turns (wgmma,
    cluster, cluster, wgmma, K1_F32_PAIRS times; graph replays): each
    kernel's times and mean, "rec_<kind>_ms"."""
    runs = {"wgmma": [], "cluster": []}

    def call(kind):
        def run():
            with recurrence.force_k1_rec(kind):
                return recurrence.lstm_recurrence_k1(
                    xproj, w_hh, H, seq_out, fused_lstm.launches, packed)
        return run

    for _ in range(K1_F32_PAIRS):
        for kind in ("wgmma", "cluster", "cluster", "wgmma"):
            runs[kind].append(graph_ms(torch, call(kind), reps=10))
    return {**{f"rec_{k}_ms_runs": v for k, v in runs.items()},
            **{f"rec_{k}_ms": statistics.mean(v) for k, v in runs.items()}}


def time_narrow_extra(torch, fused_lstm, plain) -> list:
    """Phase 3, the narrow layers at NARROW_EXTRA_TIMED's batches (train's
    evaluation tiles, denoise's signal_bilstm first layer): the three
    routes in turns (f32_turns), beside the plain version and the bounds
    (3xTF32, and FFMA)."""
    rows = []
    for Fa, Fb, H, batches in NARROW_EXTRA_TIMED:
        xs, w_ih, b, w_hh = layer_inputs(torch, Fa, Fb, H, max(batches),
                                         torch.float32)
        packed = {"split": split_packed(fused_lstm, w_ih, w_hh, Fa),
                  "narrow": fused_lstm.pack_narrow_weights(w_ih, w_hh)}
        for B in batches:
            x = tuple(v[:, :B].contiguous() for v in xs)
            row = f32_turns(torch, fused_lstm, Fa, Fb, H, True, x, w_ih, b,
                            w_hh, packed)
            ops_ms, bytes_ms = layer_bound(Fa, Fb, H, True, B, 4,
                                           PEAK_TF32_FLOPS, TF32_PASSES)
            row.update({"F": [Fa, Fb], "H": H, "B": B,
                        "plain_ms": cuda_ms(torch, lambda: plain.bilstm_layer(
                            x, w_ih, b, w_hh, H, True), reps=5),
                        "bound_ms": max(ops_ms, bytes_ms),
                        "ffma_bound_ms": max(layer_bound(
                            Fa, Fb, H, True, B, 4, PEAK_F32_FLOPS)[0],
                            bytes_ms)})
            log("K1 float32 narrow layer timing " + json.dumps(row))
            rows.append(row)
            del x
        del xs, w_ih, b, w_hh, packed
    return rows


# the packer of each packing packed_for names
K1_BF16_PACKERS = {"wgmma": "pack_weights_wgmma", "mma": "pack_weights",
                   "resident": "pack_weights_resident"}


def k1_bf16_packed(fused_lstm, F, H, B, w_ih, w_hh):
    """The weights packed for the bfloat16 kernel and design the layer
    takes (packed_for), as a model caches them."""
    kind = fused_lstm.packed_for(F, H, B)
    return getattr(fused_lstm, K1_BF16_PACKERS[kind])(w_ih, w_hh)


def k1_bf16_layer_times(tree: str) -> dict:
    """``--k1-bf16-times <tree>``: device ms (graph replays) of each main-path
    bfloat16 layer at TILE and TAIL rows through bilstm_layer_fused of the
    package in checkout ``tree`` (its own kernels, built under its
    build/), over weights packed beforehand: the same timing for this
    tree and another (the parent's), each in a fresh process."""
    import torch
    sys.path.insert(0, os.path.abspath(tree))
    from deepsignal_plant_tpu_torch.ops import fused_lstm
    out = {}
    for name, (Fa, Fb, H, seq_out) in MAIN_PATH_LAYERS.items():
        xs, w_ih, b, w_hh = layer_inputs(torch, Fa, Fb, H, TILE,
                                         torch.bfloat16)
        for B in (TILE, TAIL):
            x = tuple(v[:, :B].contiguous() for v in xs)
            packed = k1_bf16_packed(fused_lstm, Fa + Fb, H, B, w_ih, w_hh)
            out[f"{name} {B}"] = graph_ms(
                torch, lambda: fused_lstm.bilstm_layer_fused(
                    x, w_ih, b, w_hh, H, seq_out, packed=packed), reps=10)
    return out


def time_k1_bf16_ab(parent: str) -> dict:
    """Phase 3d: the bfloat16 layers of this tree and of ``parent`` (an
    unpacked ``git archive`` of the parent commit; skipped where it is
    missing) in turns, parent, this, this, parent, each a fresh process
    of k1_bf16_layer_times; per tree the mean of its two runs a layer and
    the sums over a TILE-row and a TAIL-row tile."""
    if not os.path.isdir(os.path.join(parent, "deepsignal_plant_tpu_torch")):
        log(f"phase 3d: no parent tree at {parent}: skipped")
        return {}
    runs = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--k1-bf16-times",
             parent if who == "parent" else REPO], capture_output=True,
            text=True, timeout=1200)
        if proc.returncode:
            fail(f"phase 3d, {who}'s K1 bf16 times failed:\n"
                 + proc.stdout[-2000:] + proc.stderr[-4000:])
        runs[who].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    out = {}
    for who, rs in runs.items():
        layers = {k: statistics.mean(r[k] for r in rs) for k in rs[0]}
        out[who] = {"layers_ms": layers, "runs": rs,
                    **{f"tile_{B}_ms": sum(v for k, v in layers.items()
                                           if k.endswith(f" {B}"))
                       for B in (TILE, TAIL)}}
    log("phase 3d, K1 bf16 layers, parent vs this tree in turns: "
        + json.dumps({who: {k: v for k, v in o.items() if k != "runs"}
                      for who, o in out.items()}))
    return out


def time_k1_bf16(torch, fused_lstm, Fa, Fb, H, seq_out, xs, w_ih, b, w_hh):
    """Phase 3, K1 at bfloat16, one main-path layer at B=4096 and at the
    TAIL rows: the wgmma kernel (the route bilstm_layer_fused takes, on
    k1_bf16_plan's plan) and the mma.sync kernel in turns,
    K1_BF16_PAIRS times (mma, wgmma, wgmma, mma; graph replays, each
    over its weights packed beforehand, as a model caches them), their
    means, CUDA events per call. The L2 bytes of weights each design
    reads (fused_lstm.weight_l2_bytes: by design, not measured) go to the
    log beside them, not into the result."""
    out = {}
    layer = {"wgmma": fused_lstm.bilstm_layer_fused,
             "mma": fused_lstm.layer_bf16_mma}
    for B in (TILE, TAIL):
        x = tuple(v[:, :B].contiguous() for v in xs)
        pre = "" if B == TILE else "tail_"
        packed = {"wgmma": k1_bf16_packed(fused_lstm, Fa + Fb, H, B, w_ih,
                                          w_hh),
                  "mma": fused_lstm.pack_weights(w_ih, w_hh)}

        def call(k):
            return lambda: layer[k](x, w_ih, b, w_hh, H, seq_out,
                                    packed=packed[k])

        runs = {"mma": [], "wgmma": []}
        for _ in range(K1_BF16_PAIRS):
            for k in ("mma", "wgmma", "wgmma", "mma"):
                runs[k].append(graph_ms(torch, call(k), reps=10))
        plan = fused_lstm.k1_bf16_plan(Fa + Fb, H, B)
        row = {"plan": dict(zip(("kind", "stages", "x_buffers"), plan)),
               "device_ms_runs": runs["wgmma"],
               "mma_device_ms_runs": runs["mma"],
               "device_ms": statistics.mean(runs["wgmma"]),
               "mma_device_ms": statistics.mean(runs["mma"]),
               "kernel_ms": cuda_ms(torch, call("wgmma")),
               "mma_kernel_ms": cuda_ms(torch, call("mma"))}
        l2 = {k: fused_lstm.weight_l2_bytes(k, T, Fa + Fb, H, B)
              for k in ("wgmma", "mma")}
        log(f"K1 bf16, F={Fa + Fb} H={H} B={B}: device ms wgmma "
            f"{row['device_ms']:.4f}, mma.sync {row['mma_device_ms']:.4f}; "
            f"L2 bytes of weights by design (not measured) {l2}")
        out.update({pre + k: v for k, v in row.items()})
        del x
    out["tail_B"] = TAIL
    return out


def time_kernel(torch, fused_lstm, recurrence, plain):
    """Phase 3: each main-path launch at B=4096 and at call_mods' ragged
    tail tile (TAIL rows), through each of K1's routes (bfloat16: the
    wgmma kernel and the mma.sync kernel in turns, time_k1_bf16; float32:
    its routes in turns, time_k1_f32), beside the plain version and
    torch.nn.LSTM in the kernel's dtype. The kernels both with CUDA
    events per call and as device time (graph replays, the packed
    weights made before the capture)."""
    rows = []
    for name, (Fa, Fb, H, seq_out) in MAIN_PATH_LAYERS.items():
        for kernel, dname in K1_KERNELS.items():
            dtype = getattr(torch, dname)
            xs, w_ih, b, w_hh = layer_inputs(torch, Fa, Fb, H, TILE, dtype)
            packed = (None if dtype == torch.bfloat16 else
                      {"split": split_packed(fused_lstm, w_ih, w_hh, Fa),
                       "narrow": fused_lstm.pack_narrow_weights(w_ih, w_hh)
                       if Fa + Fb <= fused_lstm.NARROW_MAX_F else None})
            if dtype == torch.bfloat16:
                extra = time_k1_bf16(torch, fused_lstm, Fa, Fb, H, seq_out,
                                     xs, w_ih, b, w_hh)
                kernel_ms, device_ms = extra["kernel_ms"], extra["device_ms"]
            else:
                extra = time_k1_f32(torch, fused_lstm, recurrence, plain,
                                    Fa, Fb, H, seq_out, xs, w_ih, b, w_hh,
                                    packed)
                kernel_ms, device_ms = extra["kernel_ms"], extra["device_ms"]
            plain_ms = cuda_ms(torch, lambda: plain.bilstm_layer(
                xs, w_ih, b, w_hh, H, seq_out), reps=10)
            # library yardstick: torch.nn.LSTM(bidirectional) on the
            # concatenated input, same weights (torch layout), same dtype
            # (cuDNN takes no bf16, so ATen's own LSTM kernels run there;
            # float32 runs cuDNN)
            lstm = torch.nn.LSTM(Fa + Fb, H, bidirectional=True).to(
                "cuda", dtype)
            with torch.no_grad():
                for d, sfx in enumerate(("", "_reverse")):
                    getattr(lstm, "weight_ih_l0" + sfx).copy_(w_ih[d].t())
                    getattr(lstm, "weight_hh_l0" + sfx).copy_(w_hh[d].t())
                    getattr(lstm, "bias_ih_l0" + sfx).copy_(b[d])
                    getattr(lstm, "bias_hh_l0" + sfx).zero_()
            x_cat = torch.cat(xs, dim=-1).contiguous()
            # torch flattens no bf16 RNN weights (cudnn.is_acceptable
            # takes f16/f32/f64 only), so each bf16 call also compacts the
            # layer's weights (<= 3 MB of copies) and warns about it; the
            # time counts
            with torch.no_grad(), warnings.catch_warnings():
                warnings.filterwarnings("ignore", "RNN module weights")
                library_ms = cuda_ms(torch, lambda: lstm(x_cat))
            itemsize = 2 if dtype == torch.bfloat16 else 4
            # float32's bound: its products in 3xTF32 on the tensor cores
            # (the CUDA cores' FFMA bound beside it)
            ops_ms, bytes_ms = layer_bound(
                Fa, Fb, H, seq_out, TILE, itemsize,
                *((PEAK_BF16_FLOPS, 1) if itemsize == 2 else
                  (PEAK_TF32_FLOPS, TF32_PASSES)))
            if itemsize == 4:
                extra["ffma_ms"] = layer_bound(Fa, Fb, H, seq_out, TILE, 4,
                                               PEAK_F32_FLOPS)[0]
            row = {"kernel": kernel, "layer": name, "F": [Fa, Fb], "H": H,
                   "B": TILE, "seq_out": seq_out, "dtype": dname,
                   **extra, "kernel_ms": kernel_ms, "device_ms": device_ms,
                   "plain_ms": plain_ms,
                   "library_ms": library_ms, "ops_ms": ops_ms,
                   "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
                   "bound_by": ("operations" if ops_ms >= bytes_ms
                                else "bytes")}
            log("timing " + json.dumps(row))
            rows.append(row)
            del lstm, x_cat, xs, w_ih, b, w_hh, packed
    torch.cuda.synchronize()
    return rows


def time_forward(torch, ModelConfig, ModelBiLSTM, Batch, init_params):
    """Phase 3, whole model: one 4096-row bf16 forward tile through the
    kernel and through the plain version (CUDA events)."""
    out = {}
    rng = np.random.default_rng(SEED)
    arrays = (rng.integers(0, 4, (TILE, T)), rng.normal(size=(TILE, T)),
              np.abs(rng.normal(size=(TILE, T))),
              rng.integers(1, 30, (TILE, T)), rng.normal(size=(TILE, T, 16)))
    batch = Batch(*(torch.tensor(a, dtype=torch.float32 if i else
                                 torch.int64, device="cuda")
                    for i, a in enumerate(arrays)))
    for rec in ("kernel", "scan"):
        cfg = ModelConfig(dropout_rate=0.0, compute_dtype="bfloat16",
                          recurrence=rec)
        model = ModelBiLSTM.from_params(init_params(cfg, SEED), cfg, "cuda")
        with torch.inference_mode():
            out[f"forward_ms_{rec}"] = cuda_ms(torch, lambda: model(batch),
                                               reps=10)
    log("whole-model forward, 4096 rows, bf16: " + json.dumps(out))
    return out


def rec_inputs(torch, H, B, dtype, seed=SEED):
    """xproj ~ N(0, 1) (a layer's projected inputs), w_hh ~ U(-1/sqrt(H),
    1/sqrt(H)) (torch's LSTM init), dys ~ N(0, 1) (a cotangent)."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)

    def dev(a):
        return torch.tensor(a, dtype=torch.float32).to("cuda", dtype)

    return (dev(rng.normal(size=(T, 2, B, 4 * H))),
            dev(rng.uniform(-k, k, (2, H, 4 * H))),
            dev(rng.normal(size=(T, 2, B, H))))


def check_recurrence(torch, recurrence, plain):
    """Phase 2b: K2, K3, K4 and dW_hh against their plain versions at the
    training shapes (batch 512, a ragged 509, and phase 9b's 256 rows of
    a rank), K2-K4 through the plan's cluster kernel of each dtype and
    through the streaming kernel it replaces. K4 and dW_hh take the
    plain residuals, so both sides see identical inputs."""
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in REC_KERNELS}
    checked = []
    for H in (128, 256):
        for B in (TRAIN_B, TRAIN_B - 3, TRAIN_B // RANKS):
            for dname, dtype in (("float32", torch.float32),
                                 ("bfloat16", torch.bfloat16)):
                xproj, w_hh, dys = rec_inputs(torch, H, B, dtype)
                want_ys, want_cs, want_g = plain.lstm_recurrence_fwd_save(
                    xproj, w_hh, H)
                want_dx = plain.lstm_recurrence_bwd_dx(dys, want_cs, want_g,
                                                       w_hh, H)
                want_dw = plain.lstm_dw_hh(want_ys, want_dx)
                before = dict(recurrence.launches)
                ys = recurrence.lstm_recurrence(xproj, w_hh, H)
                ys_s, cs, gates = recurrence.lstm_recurrence_fwd_save(
                    xproj, w_hh, H)
                dx = recurrence.lstm_recurrence_bwd_dx(dys, want_cs, want_g,
                                                       w_hh, H)
                dw = recurrence.lstm_dw_hh(want_ys, want_dx)
                torch.cuda.synchronize()
                moved = {k: v - before[k]
                         for k, v in recurrence.launches.items()}
                sfx = "_f32" if dtype == torch.float32 else ""
                want = {k: 0 for k in moved}
                want.update({k if k == "lstm_dw_hh" else k + sfx: 1
                             for k in REC_KERNELS})
                if moved != want:
                    fail(f"the recurrence at H={H} B={B} {dname} did not "
                         f"take the {dname} cluster kernels: {moved}")
                pairs = [("lstm_recurrence_fwd", "ys", ys, want_ys),
                         ("lstm_recurrence_fwd_save", "ys", ys_s, want_ys),
                         ("lstm_recurrence_fwd_save", "cs", cs, want_cs),
                         ("lstm_recurrence_fwd_save", "gates", gates, want_g),
                         ("lstm_recurrence_bwd", "dxproj", dx, want_dx),
                         ("lstm_dw_hh", "dW_hh", dw, want_dw)]
                # the streaming kernels that phase 3b times beside them
                s_ys, s_cs, s_g = recurrence.lstm_recurrence_fwd_save(
                    xproj, w_hh, H, stream=True)
                pairs += [
                    ("stream", "K2 ys", recurrence.lstm_recurrence(
                        xproj, w_hh, H, stream=True), want_ys),
                    ("stream", "K3 ys", s_ys, want_ys),
                    ("stream", "K3 cs", s_cs, want_cs),
                    ("stream", "K3 gates", s_g, want_g),
                    ("stream", "K4 dxproj",
                     recurrence.lstm_recurrence_bwd_dx(
                         dys, want_cs, want_g, w_hh, H, stream=True),
                     want_dx)]
                torch.cuda.synchronize()
                line = []
                for kernel, what, got, want in pairs:
                    if got.shape != want.shape or got.dtype != want.dtype:
                        fail(f"{kernel} {what}: {tuple(got.shape)} "
                             f"{got.dtype}, plain {tuple(want.shape)} "
                             f"{want.dtype}")
                    if not torch.isfinite(got.float()).all():
                        fail(f"{kernel} {what} is not finite")
                    err = (got.float() - want.float()).abs().max().item()
                    tol = DW_TOL if kernel == "lstm_dw_hh" else REC_TOL[dname]
                    bound = tol * max(1.0, want.float().abs().max().item())
                    line.append(f"{what} {err:.3g} (<= {bound:.3g})")
                    if err > bound:
                        fail(f"{kernel} {what} disagrees with its plain "
                             f"version at H={H} B={B} {dname}: {err} > "
                             f"{bound}")
                    if kernel in errs:
                        errs[kernel][dname] = max(errs[kernel][dname], err)
                dx2 = recurrence.lstm_recurrence_bwd_dx(dys, want_cs, want_g,
                                                        w_hh, H)
                torch.cuda.synchronize()
                if not torch.equal(dx, dx2):
                    fail(f"lstm_recurrence_bwd (cluster) is not bitwise "
                         f"reproducible at H={H} B={B} {dname}")
                line.append("dxproj bitwise equal over two launches")
                again = recurrence.lstm_dw_hh(want_ys, want_dx)
                ys1 = want_ys[:1].contiguous()
                dw1 = recurrence.lstm_dw_hh(ys1, want_dx[:1].contiguous())
                torch.cuda.synchronize()
                if not torch.equal(dw, again):
                    fail(f"lstm_dw_hh is not bitwise reproducible at H={H} "
                         f"B={B} {dname}")
                if dw1.shape != (2, H, 4 * H) or dw1.any():
                    fail(f"lstm_dw_hh at T=1 is not all zeros (H={H})")
                line.append("dW_hh bitwise equal over two launches, zeros "
                            "at T=1")
                log(f"recurrence H={H} B={B} {dname}: max|kernel-plain| "
                    + ", ".join(line))
                checked.append([H, B, dname])
                del xproj, w_hh, dys, want_ys, want_cs, want_g, want_dx
    return errs, checked


def rec_plans(torch, recurrence) -> dict:
    """recurrence_plan's choice for each cluster kernel of each dtype at
    the training shapes, beside the occupancy query it read (clusters the
    card holds at once), the clusters the grid needs and the waves they
    take (bfloat16 must take one, float32 at most two), also at phase
    9b's batch of a rank (TRAIN_B / RANKS). A missing plan fails."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        batches = (TRAIN_B, TRAIN_B - 3, TRAIN_B // RANKS)
        for name, kind in recurrence._KIND.items():
            for H in (128, 256):
                for B in batches:
                    def cap(C, rows):
                        return recurrence.cluster_capacity(0, kind, H, C,
                                                           rows, dtype)
                    plan = recurrence.recurrence_plan(kind, B, H, cap, dtype)
                    if plan is None:
                        fail(f"{name}: no {dname} cluster plan at H={H} "
                             f"B={B}")
                    C, rows = plan
                    clusters = 2 * -(-B // rows)
                    out[f"{name} {dname} H={H} B={B}"] = {
                        "cluster": C, "rows": rows, "clusters": clusters,
                        "capacity": cap(C, rows),
                        "waves": -(-clusters // cap(C, rows)),
                        "smem_bytes": recurrence.recurrence_smem(
                            kind, H, rows, dtype),
                        "capacity_by_rows": {
                            r: cap(C, r)
                            for r in recurrence._CL_ROWS[dtype][kind]
                            if recurrence.recurrence_smem(
                                kind, H, r, dtype) <= 232448}}
    log("cluster plans (occupancy query): " + json.dumps(out))
    return out


def rec_bound(kernel, H, B, itemsize=2, peak_flops=PEAK_BF16_FLOPS,
              passes=1):
    """(ms at the peak operation rate, ms at the memory rate) of one
    recurrence launch: its products (each run ``passes`` times: 3 for
    3xTF32), and its compulsory bytes (each input read once, each output
    written once)."""
    seq = T * 2 * B * H                       # elements of ys, cs, dys
    w = 2 * H * 4 * H                          # elements of w_hh, dW
    if kernel in ("lstm_recurrence_fwd", "lstm_recurrence_fwd_save"):
        flops = 2 * 2 * T * B * H * 4 * H
        nbytes = (4 * seq + w + seq) * itemsize           # xproj, w_hh, ys
        if kernel == "lstm_recurrence_fwd_save":
            nbytes += seq * 4 + 4 * seq * itemsize          # cs, gates
    elif kernel == "lstm_recurrence_bwd":
        flops = 2 * 2 * (T - 1) * B * 4 * H * H           # dh = da @ W^T
        nbytes = (seq + 4 * seq + w + 4 * seq) * itemsize + seq * 4
    else:                                                  # lstm_dw_hh
        flops = 2 * 2 * (T - 1) * B * H * 4 * H
        step = 2 * B * H
        nbytes = (T - 1) * step * 5 * itemsize + w * 4     # ys, dx; dW f32
    return flops * passes / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3


def cudnn_lstm_ms(torch, F, H, B):
    """Yardsticks for one training layer: torch.nn.LSTM(bidirectional) on
    a (T, B, F) input — forward without grad, forward with grad (training
    mode) and forward + backward — in bf16 (the same inputs as the
    kernels; cuDNN takes no bf16, so ATen's own LSTM kernels run), in
    fp16 (cuDNN) and in float32 (cuDNN, TF32 off: the float32 kernels'
    yardstick). Each computes more than the recurrence kernels: the
    input projection too, and in the backward its gradients."""
    lstm = torch.nn.LSTM(F, H, bidirectional=True).to("cuda", torch.bfloat16)
    rng = np.random.default_rng(SEED)
    x = torch.tensor(rng.uniform(-1, 1, (T, B, F)), dtype=torch.float32
                     ).to("cuda", torch.bfloat16).requires_grad_(True)
    out = {}
    for dtype, sfx in ((torch.bfloat16, ""), (torch.float16, "_fp16"),
                       (torch.float32, "_f32")):
        lstm = lstm.to(dtype)
        x = x.detach().to(dtype).requires_grad_(True)
        params = [x, *lstm.parameters()]
        gout = torch.ones(T, B, 2 * H, device="cuda", dtype=dtype)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "RNN module weights")
            with torch.no_grad():
                out["fwd_nograd" + sfx] = cuda_ms(torch, lambda: lstm(x))
            out["fwd_train" + sfx] = cuda_ms(torch, lambda: lstm(x))
            out["fwd_bwd" + sfx] = cuda_ms(torch, lambda: torch.autograd.grad(
                lstm(x)[0], params, gout))
    return out


def time_recurrence(torch, recurrence, plain):
    """Phase 3b: each recurrence kernel at B=512 in bf16, per H, and per
    train step (two H=128 and three H=256 launches of each)."""
    per_h = {}
    for H in (128, 256):
        xproj, w_hh, dys = rec_inputs(torch, H, TRAIN_B, torch.bfloat16)
        ys, cs, gates = recurrence.lstm_recurrence_fwd_save(xproj, w_hh, H)
        dx = recurrence.lstm_recurrence_bwd_dx(dys, cs, gates, w_hh, H)
        calls = {
            "lstm_recurrence_fwd": (
                lambda: recurrence.lstm_recurrence(xproj, w_hh, H),
                lambda: plain.lstm_recurrence(xproj, w_hh, H)),
            "lstm_recurrence_fwd_save": (
                lambda: recurrence.lstm_recurrence_fwd_save(xproj, w_hh, H),
                lambda: plain.lstm_recurrence_fwd_save(xproj, w_hh, H)),
            "lstm_recurrence_bwd": (
                lambda: recurrence.lstm_recurrence_bwd_dx(dys, cs, gates,
                                                          w_hh, H),
                lambda: plain.lstm_recurrence_bwd_dx(dys, cs, gates, w_hh,
                                                     H)),
            "lstm_dw_hh": (lambda: recurrence.lstm_dw_hh(ys, dx),
                           lambda: plain.lstm_dw_hh(ys, dx)),
        }
        stream = {
            "lstm_recurrence_fwd":
                lambda: recurrence.lstm_recurrence(xproj, w_hh, H,
                                                   stream=True),
            "lstm_recurrence_fwd_save":
                lambda: recurrence.lstm_recurrence_fwd_save(
                    xproj, w_hh, H, stream=True),
            "lstm_recurrence_bwd":
                lambda: recurrence.lstm_recurrence_bwd_dx(
                    dys, cs, gates, w_hh, H, stream=True)}
        rows = {}
        for name, (kern, pl) in calls.items():
            ops_ms, bytes_ms = rec_bound(name, H, TRAIN_B)
            # kernel_ms: CUDA events around each call, the host's issue
            # time included where the device waits for it (the earlier
            # method); device_ms: replays of a CUDA graph of the calls.
            # The cluster kernels and the streaming kernels they replace
            # take turns: cluster, stream, stream, cluster.
            row = {"kernel_ms": cuda_ms(torch, kern)}
            if name in stream:
                runs = [graph_ms(torch, f) for f in
                        (kern, stream[name], stream[name], kern)]
                row.update(device_ms=(runs[0] + runs[3]) / 2,
                           device_ms_runs=[runs[0], runs[3]],
                           stream_device_ms=(runs[1] + runs[2]) / 2,
                           stream_device_ms_runs=[runs[1], runs[2]])
            else:
                row["device_ms"] = graph_ms(torch, kern)
            row.update(plain_ms=cuda_ms(torch, pl, reps=10), ops_ms=ops_ms,
                       bytes_ms=bytes_ms)
            rows[name] = row
        # the same product as one library call on the stored operands
        # (bf16 out, f32 accumulation inside cuBLAS), timed both ways

        def einsum():
            return torch.einsum("sdbh,sdbg->dhg", ys[:-1], dx[1:])

        rows["lstm_dw_hh"]["library_ms"] = cuda_ms(torch, einsum)
        rows["lstm_dw_hh"]["library_device_ms"] = graph_ms(torch, einsum)
        per_h[H] = rows
        log(f"timing recurrence H={H} B={TRAIN_B} bf16: " + json.dumps(rows))
        del xproj, w_hh, dys, ys, cs, gates, dx
    f32 = time_recurrence_f32(torch, recurrence, plain)
    library = {name: cudnn_lstm_ms(torch, F, H, TRAIN_B)
               for name, (F, H) in TRAIN_LAYERS.items()}
    probe = torch.empty(1, device="cuda", dtype=torch.bfloat16)
    log("timing torch.nn.LSTM per training layer, bf16 and fp16 (cuDNN "
        f"accepts bf16: {torch.backends.cudnn.is_acceptable(probe)}): "
        + json.dumps(library))
    torch.cuda.synchronize()

    def per_step(kernel, key):
        return sum(per_h[H][kernel][key] for _, H in TRAIN_LAYERS.values())

    lib = {"lstm_recurrence_fwd": "fwd_nograd",
           "lstm_recurrence_fwd_save": "fwd_train",
           "lstm_recurrence_bwd": "fwd_bwd"}
    out = {}
    for kernel in REC_KERNELS:
        ops_ms, bytes_ms = per_step(kernel, "ops_ms"), per_step(kernel,
                                                                 "bytes_ms")
        device_ms = per_step(kernel, "device_ms")
        out[kernel] = {
            "kernel_ms": per_step(kernel, "kernel_ms"),
            "device_ms": device_ms,
            "ms": device_ms,                     # the line's ms: device time
            "plain_ms": per_step(kernel, "plain_ms"),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": (per_step(kernel, "library_ms")
                           if kernel == "lstm_dw_hh" else
                           sum(v[lib[kernel]] for v in library.values())),
            "per_launch": {H: per_h[H][kernel] for H in per_h}}
        if kernel != "lstm_dw_hh":
            # the streaming kernel the cluster kernel replaces, same call
            out[kernel]["stream_device_ms"] = per_step(kernel,
                                                       "stream_device_ms")

    def f32_step(kernel, key):
        return sum(f32[kernel][H][key] for _, H in TRAIN_LAYERS.values())

    def f32_bound(kernel):
        ops_ms, bytes_ms = f32_step(kernel, "ops_ms"), f32_step(kernel,
                                                               "bytes_ms")
        return {"bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                # the CUDA cores' bound (FFMA at the float32 peak), which
                # the streaming kernels were held to
                "ffma_bound_ms": max(f32_step(kernel, "ffma_ms"), bytes_ms)}

    for name, kernel in F32_KERNELS.items():
        # the float32 cluster kernels, per 512-row step, the streaming
        # kernels they replace timed in turns (new, old, old, new)
        device_ms = f32_step(kernel, "device_ms")
        out[name] = {
            "kernel_ms": f32_step(kernel, "kernel_ms"),
            "device_ms": device_ms, "ms": device_ms,
            "stream_device_ms": f32_step(kernel, "stream_device_ms"),
            "plain_ms": f32_step(kernel, "plain_ms"), **f32_bound(kernel),
            "library_ms": sum(v[lib[kernel] + "_f32"]
                              for v in library.values()),
            "library_note": "torch.nn.LSTM float32 (cuDNN, TF32 off), "
                            + lib[kernel] + " (more work: the input "
                            "projection too)",
            "per_launch": f32[kernel]}
    # dW_hh's float32 kernel, which no main path launches in bf16 training
    out["lstm_dw_hh"]["float32"] = {
        "device_ms": f32_step("lstm_dw_hh", "device_ms"),
        "plain_ms": f32_step("lstm_dw_hh", "plain_ms"),
        **f32_bound("lstm_dw_hh"),
        "library_ms": f32_step("lstm_dw_hh", "library_device_ms"),
        "per_launch": f32["lstm_dw_hh"]}
    out["lstm_recurrence_bwd"]["library_note"] = (
        "torch.nn.LSTM bf16 forward + backward (more work: the forward "
        "and the input projection's gradients too)")
    out["lstm_dw_hh"]["library_device_ms"] = per_step("lstm_dw_hh",
                                                      "library_device_ms")
    out["lstm_dw_hh"]["library_note"] = (
        "torch.einsum on the bf16 operands (library_ms with the host's "
        "issue time, as kernel_ms; library_device_ms from graph replays, "
        "as device_ms)")
    return out


def time_recurrence_f32(torch, recurrence, plain):
    """Phase 3b, float32, per H at B=512: the float32 cluster kernels of
    K2, K3 and K4 and the streaming kernels they replace in turns (new,
    old, old, new; device time from graph replays), the cluster kernels
    also with CUDA events per call, the plain version (CUDA events), and
    dW_hh's float32 kernel beside torch.einsum at float32 (TF32 off) as
    device time. Bounds: the products in 3xTF32 at the TF32 peak, or the
    bytes, the larger; and the CUDA cores' (FFMA at the float32 peak)."""
    per_h = {}
    for H in (128, 256):
        xproj, w_hh, dys = rec_inputs(torch, H, TRAIN_B, torch.float32)
        ys, cs, gates = recurrence.lstm_recurrence_fwd_save(xproj, w_hh, H)
        dx = recurrence.lstm_recurrence_bwd_dx(dys, cs, gates, w_hh, H)
        calls = {
            "lstm_recurrence_fwd": (
                lambda st: recurrence.lstm_recurrence(xproj, w_hh, H,
                                                      stream=st),
                lambda: plain.lstm_recurrence(xproj, w_hh, H)),
            "lstm_recurrence_fwd_save": (
                lambda st: recurrence.lstm_recurrence_fwd_save(
                    xproj, w_hh, H, stream=st),
                lambda: plain.lstm_recurrence_fwd_save(xproj, w_hh, H)),
            "lstm_recurrence_bwd": (
                lambda st: recurrence.lstm_recurrence_bwd_dx(
                    dys, cs, gates, w_hh, H, stream=st),
                lambda: plain.lstm_recurrence_bwd_dx(dys, cs, gates, w_hh,
                                                     H)),
            "lstm_dw_hh": (lambda st: recurrence.lstm_dw_hh(ys, dx),
                           lambda: plain.lstm_dw_hh(ys, dx)),
        }
        for name, (kern, pl) in calls.items():
            ops_ms, bytes_ms = rec_bound(name, H, TRAIN_B, 4,
                                         PEAK_TF32_FLOPS, TF32_PASSES)
            row = {"ops_ms": ops_ms, "bytes_ms": bytes_ms,
                   "ffma_ms": rec_bound(name, H, TRAIN_B, 4,
                                        PEAK_F32_FLOPS)[0]}
            if name == "lstm_dw_hh":
                row["device_ms"] = graph_ms(torch, lambda: kern(False))
                row["library_device_ms"] = graph_ms(
                    torch, lambda: torch.einsum("sdbh,sdbg->dhg", ys[:-1],
                                                dx[1:]))
            else:
                runs = [graph_ms(torch, lambda st=st: kern(st))
                        for st in (False, True, True, False)]
                row.update(device_ms=(runs[0] + runs[3]) / 2,
                           device_ms_runs=[runs[0], runs[3]],
                           stream_device_ms=(runs[1] + runs[2]) / 2,
                           stream_device_ms_runs=[runs[1], runs[2]],
                           kernel_ms=cuda_ms(torch, lambda: kern(False)))
            row["plain_ms"] = cuda_ms(torch, pl, reps=5)
            per_h.setdefault(name, {})[H] = row
        del xproj, w_hh, dys, ys, cs, gates, dx
    log(f"timing recurrence B={TRAIN_B} float32: " + json.dumps(per_h))
    return per_h


def time_train_step(torch, ModelConfig, FeatureDataset, init_params,
                    train_mod, compute_dtype):
    """Phase 3c: where the time of one training step goes, at batch 512
    in ``compute_dtype`` (bfloat16, the train CLI's default, or float32)
    with the train CLI's other defaults (dropout 0.5, Adam), through
    the train loop's own step function on the resident plane: its device
    time (CUDA events) and the host's time to enqueue it, with each
    step's rows gathered by a permutation as the loop does, and on one
    fixed batch (in turns: fixed, gathered, gathered, fixed); then a
    torch.profiler trace of a few gathered steps (device busy share,
    device time by kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = ModelConfig(compute_dtype=compute_dtype)
    dev = torch.device("cuda")
    rep = train_mod.Replica(init_params(cfg, SEED), cfg, dev, "Adam",
                            train_mod.step_decay_schedule(1e-3, 32, 2, 0.1),
                            1.0)
    rng = np.random.default_rng(SEED)
    n = 32 * TRAIN_B
    ds = FeatureDataset(
        rng.integers(0, 4, (n, T)).astype(np.int32),
        rng.normal(size=(n, T)).astype(np.float32),
        np.abs(rng.normal(size=(n, T))).astype(np.float32),
        rng.integers(1, 30, (n, T)).astype(np.float32),
        rng.normal(size=(n, T, 16)).astype(np.float32),
        rng.integers(0, 2, n).astype(np.int32))
    src = train_mod.Resident(ds, dev)
    order = torch.from_numpy(rng.permutation(n)).to(dev)

    def gathered(i):
        return src.batch(order[i % 32 * TRAIN_B:(i % 32 + 1) * TRAIN_B])

    fixed_batch = gathered(0)

    def step(i, get_batch):
        return train_mod.train_step(
            [rep], [(*get_batch(i), None)], 0.5,
            [train_mod.step_generator(SEED + 1, i, dev)])

    for i in range(3):
        step(i, gathered)
    torch.cuda.synchronize()
    times = {"fixed": ([], []), "gathered": ([], [])}
    i = 3
    for mode in ("fixed", "gathered", "gathered", "fixed"):
        get = gathered if mode == "gathered" else lambda _: fixed_batch
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            step(i, get)
            times[mode][1].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            times[mode][0].append(start.elapsed_time(end))
            i += 1
    n_prof = 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(i, i + n_prof):
            step(j, gathered)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"B": TRAIN_B, "dtype": compute_dtype, "optimizer": "Adam",
           "dropout_rate": cfg.dropout_rate,
           "step_ms": statistics.median(times["gathered"][0]),
           "host_enqueue_ms": statistics.median(times["gathered"][1]),
           "step_ms_fixed_batch": statistics.median(times["fixed"][0]),
           "host_enqueue_ms_fixed_batch": statistics.median(
               times["fixed"][1]),
           "profiled_steps": n_prof, "profiled_wall_ms": wall_ms}
    if kernels:
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in kernels)
        busy, cur_s, cur_e = 0.0, *spans[0]
        for s0, e0 in spans[1:]:
            if s0 > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s0, e0
            else:
                cur_e = max(cur_e, e0)
        busy += cur_e - cur_s
        by_name: dict = {}
        for e in kernels:
            k = by_name.setdefault(e.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3 / n_prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        out.update({
            "device_busy_ms_per_step": busy / 1e3 / n_prof,
            "device_busy_share": busy / 1e3 / wall_ms,
            "kernels_per_step": sum(v[0] for v in by_name.values()) / n_prof,
            "top_kernels_ms_per_step": {k: round(v[1], 4) for k, v in top}})
    else:
        out["device_busy_share"] = "not measured (no device events)"
    log(f"train step ({compute_dtype}): " + json.dumps(out))
    return out


def run_cli(*argv: str, env: dict | None = None) -> dict:
    """One ``python -m deepsignal_plant_tpu_torch <argv> --verbose_stages``
    process (``env`` added to its environment); returns its [stages]
    counters and wall seconds."""
    cmd = [sys.executable, "-m", "deepsignal_plant_tpu_torch", *argv,
           "--verbose_stages"]
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        fail("{} exited {}:\n{}\n{}".format(
            argv[0], proc.returncode, proc.stdout[-4000:],
            proc.stderr[-4000:]))
    stages = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("[stages] ")]
    if len(stages) != 1:
        fail(f"{argv[0]} printed no [stages] line:\n" + proc.stdout[-4000:])
    st = json.loads(stages[0][len("[stages] "):])
    st["wall_seconds"] = time.time() - t0
    return st


def run_call_mods(tsv: str, ckpt: str, out: str, *extra: str) -> dict:
    """One call_mods process; its [stages] counters plus the rows it
    wrote. Every call_mods run of the main path launches K1's bfloat16
    kernel 5 times per forward tile and its float32 kernel never."""
    st = run_cli("call_mods", "-i", tsv, "-m", ckpt, "-o", out, *extra)
    with open(out) as fh:
        st["rows"] = [ln.rstrip("\n").split("\t") for ln in fh]
    log("call_mods {} {}: {}".format(
        os.path.basename(tsv), " ".join(extra) or "(defaults)",
        json.dumps({k: v for k, v in st.items() if k != "rows"})))
    if "--compute_dtype" not in extra:
        want = {k: 0 for k in st["kernel_launches"]}
        want[K1_BF16] = 5 * st["forward_tiles"]
        if st["kernel_launches"] != want:
            fail(f"call_mods launched {st['kernel_launches']} for "
                 f"{st['forward_tiles']} forward tiles (expected {want}: "
                 f"every layer through the bfloat16 kernel)")
    return st


def check_rows(st: dict, n: int) -> np.ndarray:
    rows = st["rows"]
    if len(rows) != n:
        fail(f"call_mods wrote {len(rows)} rows for {n} inputs")
    if any(len(r) != 10 for r in rows):
        fail("call_mods rows do not have 10 columns")
    p = np.array([[float(r[6]), float(r[7])] for r in rows])
    if not np.isfinite(p).all() or (p < 0).any() or (p > 1).any():
        fail("call_mods probabilities outside [0, 1]")
    return p


def f32_call_mods_launches(torch, fused_lstm, recurrence) -> dict:
    """K1's launches in a float32 call_mods run of N_ROWS rows: per
    4096-row tile (and the TAIL tile) and layer, the route and plan this
    card gives it (k1_moves)."""
    want = {k: 0 for k in fused_lstm.kernel_launches()}
    for B in [TILE] * (N_ROWS // TILE) + [TAIL]:
        for Fa, Fb, H, _ in MAIN_PATH_LAYERS.values():
            route = f32_route(torch, fused_lstm, Fa + Fb, H, B)
            plan = k1_plan(torch, recurrence, B, H)
            for k, v in k1_moves(fused_lstm, route, plan).items():
                want[k] += v
    return want


def check_main_path(tmp: str, ab, cfg_cls, init_params, save_checkpoint,
                    f32_want: dict):
    """Phase 4: the CLI end to end on the card; ``f32_want``: the float32
    run's K1 launches (f32_call_mods_launches)."""
    cfg = cfg_cls(dropout_rate=0.0)
    ckpt = os.path.join(tmp, "both_bilstm.ckpt.npz")
    save_checkpoint(ckpt, init_params(cfg, SEED), cfg)
    tsv = os.path.join(tmp, "features.tsv")
    ab.write_features(tsv, N_ROWS, SEED)
    tiles = -(-N_ROWS // TILE)

    main = run_call_mods(tsv, ckpt, os.path.join(tmp, "calls.tsv"))
    p_main = check_rows(main, N_ROWS)
    if main["compute_dtype"] != "bfloat16" or main["recurrence"] != "kernel":
        fail(f"defaults did not run bf16 through the kernel: {main}")
    if main["forward_tiles"] != tiles:
        fail(f"{main['forward_tiles']} forward tiles, expected {tiles}")
    launches = main["kernel_launches"]
    if (main["packed_sites"], main["persite_sites"]) != (N_ROWS, 0):
        fail("the float16 wire did not take the read-packed route: "
             f"{main}")

    f32k = run_call_mods(tsv, ckpt, os.path.join(tmp, "calls_f32k.tsv"),
                         "--compute_dtype", "float32", "--recurrence",
                         "kernel")
    f32p = run_call_mods(tsv, ckpt, os.path.join(tmp, "calls_f32p.tsv"),
                         "--compute_dtype", "float32", "--recurrence", "scan")
    if any(f32p["kernel_launches"].values()):
        fail("the plain (scan) run launched a kernel")
    if f32k["kernel_launches"] != f32_want:
        fail(f"the float32 kernel run launched {f32k['kernel_launches']}, "
             f"expected {f32_want} (each layer of each tile on the route "
             f"and plan this card gives it)")
    # every float32 layer starts with one launch: the narrow kernel's, the
    # in-loop kernel's or the projection kernel's
    f32_layers = k1_f32_layers(f32k["kernel_launches"])
    if f32_layers != 5 * f32k["forward_tiles"]:
        fail(f"the float32 run ran {f32_layers} K1 layers for "
             f"{f32k['forward_tiles']} forward tiles")
    p_k, p_p = check_rows(f32k, N_ROWS), check_rows(f32p, N_ROWS)
    for a, b in zip(f32k["rows"], f32p["rows"]):
        if a[:6] != b[:6] or a[9] != b[9]:
            fail(f"kernel and plain runs disagree on row keys: {a} {b}")
    calls_k = np.array([int(r[8]) for r in f32k["rows"]])
    calls_p = np.array([int(r[8]) for r in f32p["rows"]])
    calls_m = np.array([int(r[8]) for r in main["rows"]])
    dp_kp = float(np.abs(p_k[:, 1] - p_p[:, 1]).max())
    log(f"float32 kernel vs plain: {int((calls_k != calls_p).sum())} call "
        f"differences, max|dP1| = {dp_kp:.3g} (bound {P1_TOL_F32:g}); "
        f"min |p0-p1| = {float(np.abs(p_p[:, 0] - p_p[:, 1]).min()):.3g}")
    if (calls_k != calls_p).any() or dp_kp > P1_TOL_F32:
        fail("float32 kernel and plain call_mods runs disagree")
    agree = float((calls_m == calls_p).mean())
    dp_bf = float(np.abs(p_main[:, 1] - p_p[:, 1]).max())
    log(f"bfloat16 kernel vs float32 plain: agreement {agree:.6f}, "
        f"max|dP1| = {dp_bf:.3g}")
    return {"launches": launches[K1_BF16],
            "launches_by_kernel": launches, "ckpt": ckpt,
            "f32_launches_by_kernel": f32k["kernel_launches"],
            "f32_layers": f32_layers,
            "stages": {k: v for k, v in main.items() if k != "rows"},
            "sites_per_s": main["sites"] / main["seconds"],
            "f32_kernel_vs_plain_max_dp1": dp_kp,
            "bf16_vs_f32_agreement": agree, "bf16_vs_f32_max_dp1": dp_bf}


def check_rate_run(torch, ab, cm, fused_lstm, ModelConfig, tmp: str,
                   ckpt: str) -> dict:
    """Phase 4e, in this process: call_mods' engine with its defaults on
    RATE_ROWS read-structured dense rows (~3.9 bases a site), through
    call_mods_ab.rate_run (a warm-up run, then one run under
    torch.profiler: sites/s, every stage counter, the card's busy share
    and the launches of K1, whose counts it sets to 0 first). Its output
    must equal, byte for byte, the rows of per-site windows parsed on the
    host at float16 and called by the same model in the same batches, so
    the windows gathered on the card through the pinned ring are the
    right ones."""
    tsv, out = (os.path.join(tmp, f) for f in ("dense.tsv", "dense_calls.tsv"))
    ab.write_dense_features(tsv, RATE_ROWS, SEED + 5)
    # the CLI's defaults: bf16 compute (ModelConfig's own default is f32)
    eng = cm.CallModsEngine(
        ckpt, ModelConfig(dropout_rate=0.0, compute_dtype="bfloat16"),
        cm.CallConfig(), "cuda")
    rate = ab.rate_run(eng, tsv, out, fused_lstm.launches)
    st = rate["stats"]
    want = {k: 0 for k in fused_lstm.launches}
    want[K1_BF16] = 5 * st["forward_tiles"]
    if (st["sites"], st["packed_sites"]) != (RATE_ROWS, RATE_ROWS) or \
            rate["kernel_launches"] != want:
        fail(f"the rate run did not call {RATE_ROWS} sites on the packed "
             f"route through K1's bfloat16 kernel: {rate}")
    ref = []
    for fb in cm.batches_from_features_file(tsv, st["device_batch"],
                                            out_dtype="float16"):
        kmer, *feats = (torch.from_numpy(a).to("cuda") for a in (
            fb.kmer, fb.base_means, fb.base_stds, fb.base_signal_lens,
            fb.signals))
        b = cm.Batch(kmer, *(a.float() for a in feats))
        with torch.inference_mode():
            probs = cm.forward_tiled(eng.model, b).cpu().numpy()
        ref.append(cm.format_call_block(fb.sampleinfo, probs,
                                        fb.kmer).encode())
    with open(out, "rb") as fh:
        got = fh.read()
    if got != b"".join(ref):
        fail("the packed route's rows differ from per-site windows "
             "gathered on the host")
    # bytes a site of the per-site route: 13 x (int8 code + 19 halves)
    ratio = st["wire_bytes"] / (RATE_ROWS * T * 39)
    log(f"call_mods rate run: {rate['sites_per_s']:.1f} sites/s, card busy "
        f"{rate['busy_share']:.4f} of the run ({RATE_ROWS} dense rows, "
        f"{st['bases_uploaded'] / RATE_ROWS:.3f} bases a site, {ratio:.4f} "
        f"of the per-site route's wire bytes; the same rows as per-site "
        f"windows from the host); " + json.dumps(rate))
    return {**rate, "wire_ratio": ratio}


def call_accuracy(rows) -> float:
    """Share of call_mods rows whose call equals the label that
    write_features gave the row ((pos / 10) % 2)."""
    return float(np.mean([int(r[8]) == (int(r[1]) // 10) % 2
                          for r in rows]))


def check_training(tmp: str, ab):
    """Phase 4b: the train CLI end to end with its defaults, then
    call_mods with its best checkpoint."""
    tr, va = os.path.join(tmp, "train.tsv"), os.path.join(tmp, "valid.tsv")
    ab.write_features(tr, TRAIN_ROWS, SEED + 1, TRAIN_SHIFT)
    ab.write_features(va, VALID_ROWS, SEED + 2, TRAIN_SHIFT)
    st = run_cli("train", "--train_file", tr, "--valid_file", va,
                 "--model_dir", os.path.join(tmp, "model"),
                 "--max_epoch_num", "2", "--step_interval", "16")
    log("train (defaults): " + json.dumps(
        {k: v for k, v in st.items() if k != "step_losses"}))
    if (st["compute_dtype"], st["recurrence"], st["plane"]) != (
            "bfloat16", "kernel", "resident"):
        fail(f"train defaults did not run bf16 kernels on the resident "
             f"plane: {st}")
    steps = 2 * -(-TRAIN_ROWS // TRAIN_B)
    if st["steps"] != steps:
        fail(f"train ran {st['steps']} steps, expected {steps}")
    kl = st["kernel_launches"]
    want = {k: 0 for k in kl}
    want.update({"lstm_recurrence_fwd_save": 5 * steps,
                 "lstm_recurrence_bwd": 5 * steps, "lstm_dw_hh": 5 * steps,
                 K1_BF16: 5 * st["eval_tiles"]})
    if kl != want:
        fail(f"train launched {kl}, expected {want} (5 per train step of "
             f"each training kernel, K3 and K4 through the plan's cluster "
             f"kernels, 5 of K1's bfloat16 kernel per evaluation tile, no "
             f"K2, no streaming kernel)")
    losses = st["step_losses"]
    if len(losses) != steps or not np.isfinite(losses).all():
        fail("train losses are missing or not finite")
    acc = max(st["valid_accuracies"])
    log(f"train: best valid accuracy {acc:.4f} (threshold {TRAIN_ACC_MIN}); "
        f"loss {losses[0]:.4f} at step 1, {losses[-1]:.4g} at step {steps}")
    if acc <= TRAIN_ACC_MIN or st["best_accuracy"] != acc:
        fail(f"train reached valid accuracy {acc} <= {TRAIN_ACC_MIN}")
    calls = run_call_mods(va, st["best_ckpt"],
                          os.path.join(tmp, "valid_calls.tsv"))
    check_rows(calls, VALID_ROWS)
    call_acc = call_accuracy(calls["rows"])
    log(f"call_mods with the best checkpoint: accuracy {call_acc:.4f} "
        f"(train's {acc:.4f})")
    if call_acc <= TRAIN_ACC_MIN:
        fail(f"call_mods with the trained checkpoint called {call_acc} "
             f"right <= {TRAIN_ACC_MIN}")
    epoch_s = st["epoch_train_seconds"]
    return {"launches": kl, "steps": steps, "eval_tiles": st["eval_tiles"],
            "best_valid_accuracy": acc, "call_mods_accuracy": call_acc,
            "train_seconds": st["train_seconds"],
            "eval_seconds": st["eval_seconds"],
            "epoch_train_seconds": epoch_s,
            "samples_per_s": st["samples_per_s"],
            "samples_per_s_last_epoch": TRAIN_ROWS / epoch_s[-1],
            "ms_per_step_last_epoch": epoch_s[-1] / (steps // 2) * 1e3,
            "first_loss": losses[0], "last_loss": losses[-1],
            "best_ckpt": st["best_ckpt"], "valid_tsv": va}


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def check_f32_training(tmp: str, ab, recurrence, train_entry, parser,
                       init_params, ModelConfig):
    """Phase 4c: float32 training through the kernels (K3 and K4 on their
    float32 cluster kernels) against the plain version, in this process
    through the train entry point: the same 8 SGD steps, dropout 0, from
    the same initial weights."""
    tr = os.path.join(tmp, "train_f32.tsv")
    ab.write_features(tr, F32_TRAIN_STEPS * TRAIN_B, SEED + 3, TRAIN_SHIFT)
    va = os.path.join(tmp, "valid.tsv")
    res = {}
    for rec in ("kernel", "scan"):
        args = parser.parse_args([
            "train", "--train_file", tr, "--valid_file", va,
            "--model_dir", os.path.join(tmp, f"f32_{rec}"),
            "--compute_dtype", "float32", "--dropout_rate", "0",
            "--optim_type", "SGD", "--lr", "0.1", "--max_epoch_num", "1",
            "--step_interval", str(F32_TRAIN_STEPS), "--recurrence", rec])
        before = dict(recurrence.launches)
        with contextlib.redirect_stdout(io.StringIO()):
            res[rec] = train_entry(args)
        launched = {k: recurrence.launches[k] - before[k] for k in before}
        res[rec]["launches"] = launched
        # the kernel run: K3, K4 and dW_hh 5 times a step, K3 and K4 on
        # the float32 cluster kernels; the plain run: nothing
        want = {k: 0 for k in launched}
        if rec == "kernel":
            want.update({k: 5 * F32_TRAIN_STEPS for k in (
                "lstm_recurrence_fwd_save_f32", "lstm_recurrence_bwd_f32",
                "lstm_dw_hh")})
        if launched != want:
            fail(f"float32 {rec} training launched {launched}, expected "
                 f"{want}")
    lk = np.array(res["kernel"]["step_losses"])
    lp = np.array(res["scan"]["step_losses"])
    if len(lk) != F32_TRAIN_STEPS or len(lp) != F32_TRAIN_STEPS:
        fail("float32 training ran the wrong number of steps")
    dloss = float(np.abs(lk - lp).max())
    init = dict(flat_leaves(init_params(ModelConfig(dropout_rate=0.0),
                                        1234)))
    dparam = moved = 0.0
    for (name, a), (_, b) in zip(flat_leaves(res["kernel"]["params"]),
                                 flat_leaves(res["scan"]["params"])):
        dparam = max(dparam, float(np.abs(a - b).max()))
        moved = max(moved, float(np.abs(b - init[name]).max()))
    log(f"float32 training, kernel vs plain, {F32_TRAIN_STEPS} SGD steps: "
        f"max|dloss| = {dloss:.3g} (tolerance {F32_LOSS_TOL:g}; losses "
        f"{lp[0]:.5f} -> {lp[-1]:.5f}), max|dparam| = {dparam:.3g} "
        f"(tolerance {F32_PARAM_TOL:g}; the largest update from the "
        f"initial weights {moved:.3g}); valid accuracy "
        f"{res['kernel']['valid_accuracies']} vs "
        f"{res['scan']['valid_accuracies']}")
    if dloss > F32_LOSS_TOL or dparam > F32_PARAM_TOL:
        fail("float32 kernel and plain training disagree")
    return {"max_dloss": dloss, "max_dparam": dparam, "max_update": moved,
            "losses_kernel": lk.tolist(), "losses_plain": lp.tolist(),
            "launches": res["kernel"]["launches"]}


def check_k2_path(torch, bilstm, recurrence, Batch, FeatureDataset,
                  load_checkpoint, ckpt: str, valid_tsv: str):
    """Phase 4d: inference with the fused path off runs the batch-major
    structure, whose recurrence is K2: 5 launches per forward tile, logits
    against the K1 path, on a 4096-row tile and a 512-row tile of the
    trained model. At 512 rows every layer takes its dtype's cluster
    kernel; at 4096 rows the kernel of recurrence_plan on the card's
    capacity (bfloat16: the streaming kernel, no plan holds 4096 rows in
    one wave; float32: the cluster kernel in as many waves as its cost
    rule takes, the plan of K1's recurrence)."""
    params, cfg = load_checkpoint(ckpt)
    ds = FeatureDataset.from_file(valid_tsv)
    keys = [k for k in recurrence.launches
            if k.startswith("lstm_recurrence_fwd")
            and not k.startswith("lstm_recurrence_fwd_save")]
    out = {}
    for rows in (TILE, TRAIN_B):
        b, _ = ds.batch_at(slice(0, rows))
        batch = Batch(*(torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                        for a in b))
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            model = bilstm.ModelBiLSTM.from_params(
                params, cfg.with_(compute_dtype=dname, dropout_rate=0.0),
                "cuda")
            with torch.no_grad():
                k1, _ = model(batch)
                bilstm._FUSED_ENABLED = False
                for k in keys:
                    recurrence.launches[k] = 0
                k2, _ = model(batch)
                torch.cuda.synchronize()
                by_kernel = {k: recurrence.launches[k] for k in keys}
                bilstm._FUSED_ENABLED = True
            err = (k1 - k2).abs().max().item()
            bound = K2_LOGIT_TOL[dname] * max(1.0, k1.abs().max().item())
            agree = (k1.argmax(1) == k2.argmax(1)).float().mean().item()
            log(f"K2 path, {dname}, {rows} rows: K2 launches {by_kernel}; "
                f"max|logits K2 path - K1 path| = {err:.3g} (<= "
                f"{bound:.3g}); call agreement {agree:.6f}")
            want = {k: 0 for k in keys}
            for _, _, H, _ in MAIN_PATH_LAYERS.values():
                plan = recurrence.recurrence_plan(
                    0, rows, H, lambda C, r, H=H: recurrence.cluster_capacity(
                        0, 0, H, C, r, dtype), dtype)
                if rows == TRAIN_B and plan is None:
                    fail(f"K2 {dname} has no cluster plan at H={H}, "
                         f"{rows} rows")
                want["lstm_recurrence_fwd"
                     + ("_f32" if dtype == torch.float32 else "")
                     + ("" if plan else "_stream")] += 1
            if by_kernel != want:
                fail(f"inference with the fused path off launched "
                     f"{by_kernel} for one {rows}-row tile (expected {want})")
            if err > bound or not torch.isfinite(k2).all():
                fail(f"{dname} K2-path logits disagree with the K1 path")
            out[f"{dname} {rows}"] = {"launches_by_kernel": by_kernel,
                                      "max_dlogit": err, "agreement": agree}
    return out


def check_serve(tmp: str, ckpt: str, main_run: dict, ab) -> dict:
    """Phase 5, serve: the serve CLI in a fresh process (--once, the
    full-width bf16 both_bilstm, float16 wire, the default device batch)
    over a watched directory. Each served output must equal, byte for
    byte, the call_mods CLI's output on the same file (phase 4's for the
    sparse TSV; one CLI run each for the dense TSV and its .tsv.gz copy);
    the malformed file must get a .failed marker while the server goes
    on; the .npz, which is no feature container, must get a .failed
    marker too; and K1's bfloat16 kernel must launch 5 times per forward
    tile of the three files in the serving process, and no other
    kernel."""
    watch, res = (os.path.join(tmp, d) for d in ("watch", "served"))
    os.makedirs(watch)
    shutil.copy(os.path.join(tmp, "features.tsv"), watch)
    dense = os.path.join(watch, "dense.tsv")
    ab.write_dense_features(dense, SERVE_DENSE_ROWS, SEED + 7)
    with open(dense, "rb") as src, gzip.open(dense + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    with open(os.path.join(watch, "bad.tsv"), "w") as fh:
        fh.write("this\tis\tnot\ta\tfeature\trow\n")
    np.savez(os.path.join(watch, "batch.npz"), kmer=np.zeros((4, T)))
    cold = {"features.tsv": (main_run["stages"],
                             os.path.join(tmp, "calls.tsv"))}
    for name in ("dense.tsv", "dense.tsv.gz"):
        out = os.path.join(tmp, name + ".cli_calls.tsv")
        st = run_call_mods(os.path.join(watch, name), ckpt, out)
        check_rows(st, SERVE_DENSE_ROWS)
        cold[name] = ({k: v for k, v in st.items() if k != "rows"}, out)
    st = run_cli("serve", "--watch_dir", watch, "--result_dir", res,
                 "--model_path", ckpt, "--once", "--poll_s", "0.2")
    served = {r["name"]: r for r in st["requests"]}
    if sorted(served) != sorted(cold):
        fail(f"serve called {sorted(served)}, expected {sorted(cold)}")
    for name, (_, cli_out) in cold.items():
        with open(cli_out, "rb") as a, \
                open(os.path.join(res, name + ".call_mods.tsv"), "rb") as b:
            if a.read() != b.read():
                fail(f"the served calls of {name} differ from the "
                     f"call_mods CLI's")
        if not os.path.exists(os.path.join(res, name + ".done")):
            fail(f"serve left {name} without a .done marker")
    if not os.path.exists(os.path.join(res, "bad.tsv.failed")) or \
            os.path.exists(os.path.join(res, "bad.tsv.call_mods.tsv")):
        fail("the malformed input did not get a .failed marker alone")
    if not os.path.exists(os.path.join(res, "batch.npz.failed")) or \
            os.path.exists(os.path.join(res, "batch.npz.call_mods.tsv")):
        fail("the .npz that is no feature container did not get a "
             ".failed marker alone")
    tiles = sum(c["forward_tiles"] for c, _ in cold.values())
    want = {k: 0 for k in st["kernel_launches"]}
    want[K1_BF16] = 5 * tiles
    if st["forward_tiles"] != tiles or st["kernel_launches"] != want:
        fail(f"the serving process ran {st['forward_tiles']} tiles and "
             f"launched {st['kernel_launches']} (expected {tiles} tiles, "
             f"{want})")
    for name, (c, _) in cold.items():
        r = served[name]
        log(f"serve request {name}: {r['sites']} sites in "
            f"{r['seconds']:.3f} s, {r['sites_per_s']:.1f} sites/s on one "
            f"warm engine; the call_mods CLI, cold: {c['wall_seconds']:.3f}"
            f" s for the process, {c['seconds']:.3f} s in its engine "
            f"({c['sites_per_s']:.1f} sites/s)")
    log(f"serve: engine up in {st['engine_seconds']:.3f} s; process "
        f"{st['wall_seconds']:.3f} s for 3 requests and 2 polls 0.2 s "
        f"apart; K1 bf16 launches {want[K1_BF16]} = 5 x "
        f"{tiles} tiles; bad.tsv and batch.npz (no feature container) "
        f".failed")
    return {"requests": served, "engine_seconds": st["engine_seconds"],
            "wall_seconds": st["wall_seconds"],
            "cold": {n: {k: c[k] for k in ("wall_seconds", "seconds",
                                           "sites_per_s")}
                     for n, (c, _) in cold.items()},
            "launches": st["kernel_launches"],
            "outputs": [os.path.join(res, n + ".call_mods.tsv")
                        for n in sorted(cold)]}


def write_call_rows(path: str, n_rows: int, n_sites: int, seed: int
                    ) -> int:
    """A seeded call_mods output of ``n_rows`` rows: ~``n_sites`` sites
    spread over TAIR10's contigs by length, each with a random strand;
    reads of READ_SITES consecutive sites from random starts; p1 from a
    Beta(0.4, 0.4) (calls near 0 and 1, as a trained model gives), 6
    decimals; pos_in_strand -1 for 5% of the rows. Returns the sites."""
    rng = np.random.default_rng(seed)
    lens = np.array(list(TAIR10.values()), np.float64)
    per = np.maximum(1, np.round(n_sites * lens / lens.sum())).astype(int)
    chrom, pos = [], []
    for j, length in enumerate(TAIR10.values()):
        p = np.unique(rng.integers(0, length, per[j]))
        chrom.append(np.full(len(p), j))
        pos.append(p)
    chrom, pos = np.concatenate(chrom), np.concatenate(pos)
    strand = rng.integers(0, 2, len(pos))
    n_reads = -(-n_rows // READ_SITES)
    starts = rng.integers(0, len(pos) - READ_SITES, n_reads)
    site = (starts[:, None] + np.arange(READ_SITES)).reshape(-1)[:n_rows]
    p1 = np.round(rng.beta(0.4, 0.4, n_rows), 6)
    p0 = np.round(1 - p1, 6)
    pis = np.where(rng.random(n_rows) < 0.05, -1, pos[site])
    kmers = np.array(["".join(k) for k in
                      rng.choice(list("ACGT"), (256, 5))])
    reads = [f"{rng.integers(1 << 62):016x}-{r:07d}" for r in range(n_reads)]
    cols = [np.array(list(TAIR10))[chrom[site]].tolist(),
            pos[site].astype(str).tolist(),
            np.array(["+", "-"])[strand[site]].tolist(),
            pis.astype(str).tolist(),
            [reads[r] for r in (np.arange(n_rows) // READ_SITES).tolist()],
            ["t"] * n_rows, p0.astype(str).tolist(), p1.astype(str).tolist(),
            (p1 > p0).astype(int).astype(str).tolist(),
            kmers[rng.integers(0, len(kmers), n_rows)].tolist()]
    with open(path, "w") as fh:
        fh.write("\n".join("\t".join(r) for r in zip(*cols)) + "\n")
    return len(pos)


def check_call_freq(torch, cli, tmp: str, served: list) -> dict:
    """Phase 5, call_freq through the CLI's entry point in this process:
    a FREQ_ROWS-row call file plus the served outputs, each FREQ_RUNS
    entry twice, aggregated on the host and with --device_agg on the
    card; each pair must be byte-identical (gzip compared decompressed).
    Then sort_segment_reduce alone on the card on the file's first 8 MiB
    block (its upload and readback included) against np.unique on the
    host, after a check that the card's order, segments and sums equal
    the CPU's and np.unique's."""
    from deepsignal_plant_tpu_torch.io.batching import iter_byte_blocks
    from deepsignal_plant_tpu_torch.ops.segment_agg import \
        sort_segment_reduce
    from deepsignal_plant_tpu_torch.utils.fastparse import parse_call_bytes
    calls = os.path.join(tmp, "calls.big.tsv")
    t0 = time.perf_counter()
    n_sites = write_call_rows(calls, FREQ_ROWS, FREQ_SITES, SEED + 9)
    mb = os.path.getsize(calls) / 1e6
    log(f"call_freq input: {FREQ_ROWS} rows over {n_sites} sites of "
        f"{len(TAIR10)} contigs, {mb:.1f} MB, written in "
        f"{time.perf_counter() - t0:.1f} s; plus the {len(served)} served "
        f"outputs")
    n_rows = FREQ_ROWS
    for path in served:
        with open(path, "rb") as fh:
            n_rows += fh.read().count(b"\n")
    inputs = ["-i", calls] + [a for p in served for a in ("-i", p)]
    runs = {}
    for label, extra in FREQ_RUNS.items():
        outs = {}
        for how, flags in (("host", []), ("device_agg", ["--device_agg"])):
            out = os.path.join(tmp, f"freq.{len(runs)}.{how}.tsv")
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                cli.main(["call_freq", *inputs, "-o", out, *extra, *flags])
            dt = time.perf_counter() - t0
            if "--gzip" in extra:
                with gzip.open(out + ".gz", "rb") as fh:
                    outs[how] = fh.read()
            else:
                with open(out, "rb") as fh:
                    outs[how] = fh.read()
            used = [ln for ln in printed.getvalue().splitlines()
                    if "calls used" in ln]
            runs[f"{label}, {how}"] = {
                "seconds": dt, "rows_per_s": n_rows / dt,
                "out_rows": outs[how].count(b"\n"), "report": used}
        if not outs["host"] or outs["host"] != outs["device_agg"]:
            fail(f"call_freq ({label}): --device_agg output differs from "
                 f"the host's")
        log(f"call_freq ({label}): {runs[label + ', host']['out_rows']} "
            f"rows out, byte-identical; {n_rows} rows in: host "
            f"{runs[label + ', host']['seconds']:.3f} s "
            f"({runs[label + ', host']['rows_per_s']:.1f} rows/s), "
            f"--device_agg {runs[label + ', device_agg']['seconds']:.3f} s "
            f"({runs[label + ', device_agg']['rows_per_s']:.1f} rows/s); "
            f"{runs[label + ', host']['report']}")

    cb = parse_call_bytes(next(iter_byte_blocks(calls, 8 << 20)))
    hi, lo, met = cb.chrom_ids.astype(np.int64), cb.pos, cb.label
    dev = torch.device("cuda")
    got = sort_segment_reduce(hi, lo, met, dev)
    keys = hi * (1 << 40) + lo
    uk, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    if not (all(np.array_equal(a, b) for a, b in zip(
            got[:4], sort_segment_reduce(hi, lo, met, "cpu")[:4]))
            and np.array_equal(got[0], np.argsort(keys, kind="stable"))
            and got[4] == len(uk)
            and np.array_equal(got[2], np.bincount(inv))):
        fail("sort_segment_reduce on the card disagrees with the CPU's "
             "and np.unique's")

    def median_s(fn, reps=20):
        for _ in range(3):
            fn()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts)
    dev_s = median_s(lambda: sort_segment_reduce(hi, lo, met, dev))
    host_s = median_s(lambda: np.unique(keys, return_index=True,
                                        return_inverse=True))
    log(f"sort_segment_reduce on one 8 MiB block ({len(hi)} rows, "
        f"{got[4]} sites): card {dev_s * 1e3:.3f} ms with its upload and "
        f"readback; np.unique on the host {host_s * 1e3:.3f} ms")
    return {"rows": n_rows, "sites": n_sites, "mb": mb, "runs": runs,
            "block_rows": len(hi), "block_sites": int(got[4]),
            "sort_segment_reduce_ms": dev_s * 1e3,
            "np_unique_ms": host_s * 1e3}


def write_fast5_run(fast5, dirpath: str, n_reads: int, read_len: int,
                    seed: int, **signal) -> dict:
    """A seeded fast5 run through the port's writer
    (io/fast5.write_tombo_fast5), in synth_fast5_dir's model: each read
    a random window of a random contig, events of 3-20 samples, DAC
    300-699, strands alternating; ``signal`` the writer's Signal storage
    keywords. A seed gives the same first reads at any ``n_reads``.
    Returns the run's totals."""
    rng = np.random.default_rng(seed)
    genome = {name: np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n)].tobytes().decode()
        for name, n in FAST5_GENOME.items()}
    names = list(genome)
    os.makedirs(dirpath)
    samples = 0
    for r in range(n_reads):
        chrom = names[r % len(names)]
        seq = genome[chrom]
        start = int(rng.integers(0, len(seq) - read_len))
        bases = seq[start:start + read_len]
        lens = rng.integers(3, FAST5_MAX_EVENT, read_len)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        raw = rng.integers(300, 700, int(lens.sum())).astype(np.int16)
        samples += len(raw)
        fast5.write_tombo_fast5(
            os.path.join(dirpath, f"smokeread_{r:05d}.fast5"),
            readname=f"smokeread_{r:05d}", raw_signal=raw, bases=bases,
            event_starts=starts, event_lengths=lens, chrom=chrom,
            chrom_start=start, alignstrand="+" if r % 2 == 0 else "-",
            **signal)
    nbytes = sum(os.path.getsize(os.path.join(dirpath, f))
                 for f in os.listdir(dirpath))
    return {"reads": n_reads, "bases": n_reads * read_len,
            "samples": samples, "bytes": nbytes,
            "genome_bases": sum(FAST5_GENOME.values())}


def run_extract(*argv: str) -> dict:
    """One ``python -m deepsignal_plant_tpu_torch extract`` process: its
    wall seconds, the seconds it reports for extract_features, and its
    failed-file line."""
    cmd = [sys.executable, "-m", "deepsignal_plant_tpu_torch", "extract",
           *argv]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        fail("extract exited {}:\n{}\n{}".format(
            proc.returncode, proc.stdout[-4000:], proc.stderr[-4000:]))
    failed = [ln for ln in proc.stdout.splitlines() if "files failed" in ln]
    cost = [ln for ln in proc.stdout.splitlines()
            if "extract_features costs" in ln]
    if not failed or not failed[0].startswith("0 of ") or not cost:
        fail("extract failed files or printed no summary:\n"
             + proc.stdout[-2000:])
    return {"wall_seconds": wall,
            "seconds": float(cost[0].split("costs")[1].split()[0])}


def file_digest(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(8 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def sorted_rows(path: str) -> list:
    with open(path, "rb") as fh:
        return sorted(fh.read().splitlines())


def f32_layers(st: dict) -> int:
    """K1 float32 layers a run launched (k1_f32_layers)."""
    return k1_f32_layers(st["kernel_launches"])


def check_fast5(tmp: str, ckpt: str) -> dict:
    """Phase 6: the fast5 paths, with the port's own HDF5 reader (the
    card machine has no h5py). A seeded run of FAST5_READS fast5s; the
    reader timed alone; ``extract`` to a TSV with --nproc 4 and 1 (same
    bytes); ``call_mods`` straight on the fast5 directory (bf16, float16
    wire, --nproc 4: K1's bfloat16 kernel 5 times per forward tile, the
    rows equal, sorted, to call_mods on the extracted TSV); float32 on
    FAST5_SUB_READS reads (kernel vs the TSV plane byte-identical, vs
    the plain version within P1_TOL_F32 with no call flipped); ``serve
    --once`` over one run-folder of those reads (served bytes = the
    CLI's, a .done marker)."""
    from deepsignal_plant_tpu_torch.io import fast5
    base = os.path.join(REPO, "build", "smoke_fast5")
    shutil.rmtree(base, ignore_errors=True)
    try:
        out = _check_fast5(fast5, base, tmp, ckpt)
        # phase 6c: VBZ and gzip twins of the first VBZ_READS reads
        out["vbz"] = check_vbz(fast5, base, tmp, ckpt, out)
        # phase 6d: the committed fast5 feature fixtures
        out["features"] = check_features(fast5, tmp, ckpt)
        # phase 7 on the first NPZ_READS of the same reads
        out["npz"] = check_npz(base, tmp, ckpt)
        return out
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _check_fast5(fast5, base: str, tmp: str, ckpt: str) -> dict:
    run_dir = os.path.join(base, "run")
    t0 = time.perf_counter()
    fix = write_fast5_run(fast5, run_dir, FAST5_READS, FAST5_READ_LEN,
                          SEED + 11)
    log(f"fast5 run: {fix['reads']} reads of {FAST5_READ_LEN} bases "
        f"(cut from real ONT reads of 5-20 kb to keep this phase short), "
        f"{fix['samples']} raw samples, {fix['bytes'] / 1e6:.1f} MB on disk, "
        f"genome of {len(FAST5_GENOME)} contigs ({fix['genome_bases']} "
        f"bases); written in {time.perf_counter() - t0:.1f} s by the "
        f"port's writer")
    files = sorted(os.path.join(run_dir, f) for f in os.listdir(run_dir))
    t0 = time.perf_counter()
    n_bases = 0
    for p in files:
        read = fast5.read_tombo_fast5(p)
        n_bases += len(read.seq)
    dt = time.perf_counter() - t0
    if n_bases != fix["bases"]:
        fail(f"the reader saw {n_bases} bases, {fix['bases']} written")
    reader = {"seconds": dt, "reads_per_s": len(files) / dt,
              "mb_per_s": fix["bytes"] / 1e6 / dt}
    log(f"fast5 reader alone (io/hdf5.py, no h5py): {len(files)} reads in "
        f"{dt:.3f} s, {reader['reads_per_s']:.1f} reads/s, "
        f"{reader['mb_per_s']:.1f} MB/s")

    # extract, --nproc 4 then 1: the same bytes
    tsv4, tsv1 = (os.path.join(tmp, f"fast5_features.p{n}.tsv")
                  for n in (4, 1))
    ext = {n: run_extract("-i", run_dir, "-o", out, "--nproc", str(n))
           for n, out in ((4, tsv4), (1, tsv1))}
    if file_digest(tsv4) != file_digest(tsv1):
        fail("extract wrote different bytes at --nproc 4 and 1")
    with open(tsv1, "rb") as fh:
        n_rows = sum(chunk.count(b"\n") for chunk in
                     iter(lambda: fh.read(8 << 20), b""))
    for n, e in ext.items():
        e["rows_per_s"] = n_rows / e["seconds"]
        log(f"extract --nproc {n}: {n_rows} rows in {e['seconds']:.1f} s "
            f"in extract_features ({e['rows_per_s']:.1f} rows/s; process "
            f"{e['wall_seconds']:.1f} s), "
            f"{os.path.getsize(tsv1) / 1e6:.1f} MB of TSV; byte-identical "
            f"across --nproc")

    # call_mods on the fast5 directory (bf16, float16 wire) and on the TSV
    fused = run_call_mods(run_dir, ckpt, os.path.join(tmp, "f5_calls.tsv"),
                          "--nproc", "4")
    on_tsv = run_call_mods(tsv1, ckpt, os.path.join(tmp, "f5_tsv_calls.tsv"))
    check_rows(fused, n_rows)
    if (fused["packed_sites"], fused["fast5_files"],
            fused["fast5_errors"]) != (n_rows, FAST5_READS, 0):
        fail(f"the fused run did not call every site on the packed route: "
             f"{ {k: v for k, v in fused.items() if k != 'rows'} }")
    if sorted_rows(os.path.join(tmp, "f5_calls.tsv")) != \
            sorted_rows(os.path.join(tmp, "f5_tsv_calls.tsv")):
        fail("call_mods on the fast5 directory and on its extracted TSV "
             "wrote different rows")
    log(f"call_mods on the fast5 directory (bf16, float16 wire, --nproc 4):"
        f" {fused['sites']} sites, {fused['sites_per_s']:.1f} sites/s in "
        f"the engine ({fused['seconds']:.3f} s; process "
        f"{fused['wall_seconds']:.1f} s), K1 bf16 launches "
        f"{fused['kernel_launches'][K1_BF16]} = 5 x "
        f"{fused['forward_tiles']} tiles; rows equal, sorted, to call_mods "
        f"on the extracted TSV ({on_tsv['sites_per_s']:.1f} sites/s); "
        f"stages " + json.dumps({k: fused[k] for k in STAGE_FIELDS}))

    # float32 on the first reads: kernel (fused and TSV) against plain
    sub = os.path.join(base, "sub")
    os.makedirs(sub)
    for p in files[:FAST5_SUB_READS]:
        shutil.copy(p, sub)
    sub_tsv = os.path.join(tmp, "fast5_sub.tsv")
    run_extract("-i", sub, "-o", sub_tsv, "--nproc", "1")
    f32 = ("--compute_dtype", "float32", "--transfer_dtype", "float32")
    k_f5 = run_call_mods(sub, ckpt, os.path.join(tmp, "f5_f32k.tsv"), *f32,
                         "--recurrence", "kernel", "--nproc", "4")
    k_tsv = run_call_mods(sub_tsv, ckpt, os.path.join(tmp, "f5_f32t.tsv"),
                          *f32, "--recurrence", "kernel")
    p_f5 = run_call_mods(sub, ckpt, os.path.join(tmp, "f5_f32p.tsv"), *f32,
                         "--recurrence", "scan", "--nproc", "4")
    if any(p_f5["kernel_launches"].values()):
        fail("the plain float32 fast5 run launched a kernel")
    if f32_layers(k_f5) != 5 * k_f5["forward_tiles"] or \
            k_f5["kernel_launches"][K1_BF16]:
        fail(f"the float32 fast5 run launched {k_f5['kernel_launches']} "
             f"for {k_f5['forward_tiles']} forward tiles")
    if sorted_rows(os.path.join(tmp, "f5_f32k.tsv")) != \
            sorted_rows(os.path.join(tmp, "f5_f32t.tsv")):
        fail("float32 call_mods on the fast5 directory and on its "
             "extracted TSV wrote different rows")
    pk, pp = check_rows(k_f5, k_f5["sites"]), check_rows(p_f5, k_f5["sites"])
    for a, b in zip(k_f5["rows"], p_f5["rows"]):
        if a[:6] != b[:6] or a[9] != b[9]:
            fail(f"float32 fast5 kernel and plain rows differ: {a} {b}")
    flips = int(sum(a[8] != b[8] for a, b in zip(k_f5["rows"],
                                                 p_f5["rows"])))
    dp = float(np.abs(pk[:, 1] - pp[:, 1]).max())
    if flips or dp > P1_TOL_F32:
        fail(f"float32 fast5 kernel vs plain: {flips} call differences, "
             f"max|dP1| {dp:.3g} (bound {P1_TOL_F32:g})")
    log(f"float32 on {FAST5_SUB_READS} fast5 reads: {k_f5['sites']} sites;"
        f" kernel rows equal, sorted, to the TSV plane's; kernel vs plain: "
        f"0 call differences, max|dP1| = {dp:.3g} (bound {P1_TOL_F32:g}); "
        f"K1 float32 layers {f32_layers(k_f5)} = 5 x "
        f"{k_f5['forward_tiles']} tiles")

    # serve --once over one run-folder of the same reads
    watch, res = (os.path.join(base, d) for d in ("watch", "served"))
    os.makedirs(watch)
    shutil.copytree(sub, os.path.join(watch, "run_0001"))
    cli_sub = run_call_mods(sub, ckpt, os.path.join(tmp, "f5_sub_cli.tsv"))
    st = run_cli("serve", "--watch_dir", watch, "--result_dir", res,
                 "--model_path", ckpt, "--once", "--poll_s", "0.2")
    with open(os.path.join(tmp, "f5_sub_cli.tsv"), "rb") as a, \
            open(os.path.join(res, "run_0001.call_mods.tsv"), "rb") as b:
        if a.read() != b.read():
            fail("the served calls of the run-folder differ from the "
                 "call_mods CLI's")
    if not os.path.exists(os.path.join(res, "run_0001.done")):
        fail("serve left the run-folder without a .done marker")
    req = st["requests"]
    want = {k: 0 for k in st["kernel_launches"]}
    want[K1_BF16] = 5 * st["forward_tiles"]
    if len(req) != 1 or st["kernel_launches"] != want:
        fail(f"serve over the run-folder: {st}")
    log(f"serve --once over a run-folder of {FAST5_SUB_READS} fast5s: "
        f"{req[0]['sites']} sites in {req[0]['seconds']:.3f} s "
        f"({req[0]['sites_per_s']:.1f} sites/s) on one warm engine, bytes "
        f"= the call_mods CLI's ({cli_sub['wall_seconds']:.1f} s cold "
        f"process), .done written; process {st['wall_seconds']:.1f} s")
    # phase 9 calls the same reads over two ranks after this run is gone
    shutil.copytree(sub, os.path.join(tmp, "fast5_sub"))
    return {"fixture": fix, "reader": reader, "extract": ext,
            "rows": n_rows,
            "call_mods": {k: v for k, v in fused.items() if k != "rows"},
            "call_mods_tsv_sites_per_s": on_tsv["sites_per_s"],
            "float32": {"sites": k_f5["sites"], "max_dp1": dp,
                        "launches": k_f5["kernel_launches"]},
            "serve": {"request": req[0], "wall_seconds": st["wall_seconds"],
                      "engine_seconds": st["engine_seconds"]}}


def time_reader(fast5, files: list) -> dict:
    """read_tombo_fast5 over ``files`` in turn: reads/s and MB/s (file
    bytes)."""
    nbytes = sum(os.path.getsize(p) for p in files)
    t0 = time.perf_counter()
    for p in files:
        fast5.read_tombo_fast5(p)
    dt = time.perf_counter() - t0
    return {"seconds": dt, "reads_per_s": len(files) / dt,
            "mb_per_s": nbytes / 1e6 / dt, "mb": nbytes / 1e6}


def check_vbz(fast5, base: str, tmp: str, ckpt: str, phase6: dict
              ) -> dict:
    """Phase 6c: VBZ (HDF5 filter 32020) on the card's machine, which
    has no h5py and no vbz plugin. libzstd.so.1 loads (its version
    printed); the first VBZ_READS reads of phase 6 are written again by
    the port's writer with Signal chunked, VBZ-encoded by
    tests/torch_vbz.py and gzip; every twin reads as the original; the
    reader's reads/s and MB/s on each (two passes in turns, the faster
    kept); ``extract --nproc 4`` on the VBZ twin writes the original's
    TSV bytes; fused ``call_mods`` (bf16, float16 wire, --nproc 4) on
    the original and on both twins in one process after a warm-up run:
    rows equal, K1's bfloat16 kernel 5 times per forward tile, sites/s
    and parse_wait_seconds."""
    t_phase = time.time()
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_vbz
    from deepsignal_plant_tpu_torch.io import vbz
    zver = int(vbz.libzstd().ZSTD_versionNumber())
    log(f"phase 6c: {vbz.ZSTD_LIBRARY} loaded, ZSTD_versionNumber {zver}")
    run = os.path.join(base, "run")
    orig = os.path.join(base, "vbz_orig")
    os.makedirs(orig)
    for f in sorted(os.listdir(run))[:VBZ_READS]:
        os.symlink(os.path.join(run, f), os.path.join(orig, f))
    twins = {"vbz": dict(signal_chunks=VBZ_CHUNK,
                         signal_filters=[(32020, torch_vbz.MINKNOW)],
                         signal_encode=torch_vbz.chunk_encoder()),
             "gzip": dict(signal_chunks=VBZ_CHUNK,
                          signal_filters=[(1, (4,))])}
    dirs = {"orig": orig}
    for name, kw in twins.items():
        dirs[name] = os.path.join(base, f"twin_{name}")
        t0 = time.perf_counter()
        write_fast5_run(fast5, dirs[name], VBZ_READS, FAST5_READ_LEN,
                        SEED + 11, **kw)
        log(f"{name} twin of {VBZ_READS} reads written by the port's writer"
            f" in {time.perf_counter() - t0:.1f} s")
    files = {k: sorted(os.path.join(d, f) for f in os.listdir(d))
             for k, d in dirs.items()}
    for i, p in enumerate(files["orig"]):
        want = fast5.read_tombo_fast5(p)
        for name in twins:
            got = fast5.read_tombo_fast5(files[name][i])
            if got.readname != want.readname or not np.array_equal(
                    got.raw_signal, want.raw_signal) or not np.array_equal(
                    got.event_starts, want.event_starts) or \
                    got.seq != want.seq:
                fail(f"the {name} twin of {os.path.basename(p)} reads "
                     "differently from the original")
    # in turns (orig, vbz, gzip, gzip, vbz, orig); the faster pass kept
    order = list(files) + list(files)[::-1]
    reader = {}
    for k in order:
        r = time_reader(fast5, files[k])
        if k not in reader or r["seconds"] < reader[k]["seconds"]:
            reader[k] = r
    for k, r in reader.items():
        log(f"fast5 reader alone on the {k} reads: {VBZ_READS} reads "
            f"({r['mb']:.1f} MB) in {r['seconds']:.3f} s, "
            f"{r['reads_per_s']:.1f} reads/s, {r['mb_per_s']:.1f} MB/s")

    tsv = {k: os.path.join(tmp, f"vbz_{k}.tsv") for k in ("orig", "vbz")}
    ext = {k: run_extract("-i", dirs[k], "-o", tsv[k], "--nproc", "4")
           for k in tsv}
    if file_digest(tsv["vbz"]) != file_digest(tsv["orig"]):
        fail("extract --nproc 4 on the VBZ twin wrote other bytes than on "
             "the contiguous original")
    with open(tsv["orig"], "rb") as fh:
        n_rows = fh.read().count(b"\n")
    for k, e in ext.items():
        e["rows_per_s"] = n_rows / e["seconds"]
        log(f"extract --nproc 4 on the {k} reads: {n_rows} rows in "
            f"{e['seconds']:.2f} s ({e['rows_per_s']:.1f} rows/s; process "
            f"{e['wall_seconds']:.1f} s); VBZ bytes = the original's")

    # a first run on the original carries the process's CUDA start and
    # kernel loads, so the three compared runs are warm alike
    calls = {k: os.path.join(tmp, f"vbz_{k}.calls.tsv")
             for k in ("warm", *dirs)}
    sts = dict(zip(calls, run_cli_many(
        [["call_mods", "-i", dirs.get(k, orig), "-m", ckpt, "-o", calls[k],
          "--nproc", "4"] for k in calls])))
    want = sorted_rows(calls["orig"])
    if len(want) != n_rows:
        fail(f"call_mods on the original reads wrote {len(want)} rows for "
             f"{n_rows} sites")
    for k, st in sts.items():
        k1_only(st, f"call_mods on the {k} reads")
        if sorted_rows(calls[k]) != want:
            fail(f"call_mods on the {k} twin wrote other rows than on the "
                 "original")
        if (st["fast5_files"], st["fast5_errors"]) != (VBZ_READS, 0):
            fail(f"call_mods on the {k} reads: {st['fast5_files']} files, "
                 f"{st['fast5_errors']} errors")
        log(f"call_mods on the {k} reads (bf16, float16 wire, --nproc 4): "
            f"{st['sites']} sites, {st['sites_per_s']:.1f} sites/s in the "
            f"engine, parse_wait_seconds {st['parse_wait_seconds']:.3f} of "
            f"{st['seconds']:.3f} s; K1 bf16 launches "
            f"{st['kernel_launches'][K1_BF16]} = 5 x "
            f"{st['forward_tiles']} tiles; rows = the original's")
    out = {"zstd_version": zver, "reads": VBZ_READS, "chunk": VBZ_CHUNK,
           "reader": reader, "extract": ext, "rows": n_rows,
           "call_mods": {k: {f: st[f] for f in (
               "sites", "sites_per_s", "seconds", "parse_wait_seconds",
               "forward_tiles", "kernel_launches", "wall_seconds")}
               for k, st in sts.items()},
           "phase6_reader_reads_per_s": phase6["reader"]["reads_per_s"],
           "seconds": time.time() - t_phase}
    log(f"phase 6c took {out['seconds']:.1f} s")
    return out


def same_read(got, want) -> bool:
    """Two TomboReads equal field for field (arrays: dtype and values)."""
    for k in ("readname", "read_strand", "alignstrand", "chrom",
              "chrom_start", "seq"):
        if getattr(got, k) != getattr(want, k):
            return False
    return all(getattr(got, k).dtype == getattr(want, k).dtype
               and np.array_equal(getattr(got, k), getattr(want, k))
               for k in ("raw_signal", "event_starts", "event_lengths"))


def copies_of_one(rows: list, n: int) -> int:
    """The rows of one file, where ``rows`` are those of ``n`` files of
    one read: each distinct row must occur exactly ``n`` times (every
    file wrote the same rows); 0 where not."""
    counts = Counter(tuple(r) for r in rows)
    return len(counts) if counts and set(counts.values()) == {n} else 0


def check_features(fast5, tmp: str, ckpt: str) -> dict:
    """Phase 6d: the fast5 feature fixtures (FEATURE_DIR), one read
    stored plain and once per HDF5 structure, on the card's machine,
    which has no h5py: every file reads as plain.fast5, field for field;
    the reader's reads/s on each file (two passes in turns, the faster
    kept); ``extract --nproc 4`` on the directory and fused ``call_mods``
    (bf16, float16 wire, --nproc 4) write each file's rows equal to every
    other's, the plain file's among them (every distinct row once per
    file), with K1's bfloat16 kernel 5 times per forward tile."""
    t_phase = time.time()
    names = sorted(f[:-len(".fast5")] for f in os.listdir(FEATURE_DIR)
                   if f.endswith(".fast5"))
    if "plain" not in names or len(names) < 2:
        fail(f"phase 6d: no feature fixtures in {FEATURE_DIR}: {names}")
    paths = {n: os.path.join(FEATURE_DIR, n + ".fast5") for n in names}
    plain = fast5.read_tombo_fast5(paths["plain"])
    for n, p in paths.items():
        if not same_read(fast5.read_tombo_fast5(p), plain):
            fail(f"phase 6d: {n}.fast5 reads otherwise than plain.fast5")
    rates: dict = {}
    for order in (names, names[::-1]):
        for n in order:
            t0 = time.perf_counter()
            for _ in range(FEATURE_READS):
                fast5.read_tombo_fast5(paths[n])
            rate = FEATURE_READS / (time.perf_counter() - t0)
            rates[n] = max(rates.get(n, 0.0), rate)
    log(f"phase 6d: {len(names)} feature fixtures ({len(plain.seq)} bases,"
        f" {len(plain.raw_signal)} samples each) read as plain.fast5, field"
        f" for field; reader reads/s (best of two passes of "
        f"{FEATURE_READS} in turns): " + json.dumps(
            {n: round(r, 1) for n, r in rates.items()}))
    tsv = os.path.join(tmp, "features_6d.tsv")
    ext = run_extract("-i", FEATURE_DIR, "-o", tsv, "--nproc", "4")
    rows = sorted_rows(tsv)
    per_file = copies_of_one(rows, len(names))
    if not per_file:
        fail(f"phase 6d: extract wrote {len(rows)} rows for {len(names)} "
             "files of one read that are not each file's same rows")
    calls = os.path.join(tmp, "features_6d.calls.tsv")
    st = run_call_mods(FEATURE_DIR, ckpt, calls, "--nproc", "4")
    k1_only(st, "phase 6d call_mods")
    check_rows(st, len(rows))
    if (st["fast5_files"], st["fast5_errors"]) != (len(names), 0):
        fail(f"phase 6d call_mods: {st['fast5_files']} files, "
             f"{st['fast5_errors']} errors")
    if copies_of_one(st["rows"], len(names)) != per_file:
        fail("phase 6d: call_mods wrote rows that differ across the "
             "feature files")
    out = {"files": names, "reads_per_file": FEATURE_READS,
           "reader_reads_per_s": rates, "extract": ext,
           "rows_per_file": per_file,
           "call_mods": {k: v for k, v in st.items() if k != "rows"},
           "seconds": time.time() - t_phase}
    log(f"phase 6d: extract --nproc 4 and call_mods (bf16, float16 wire, "
        f"--nproc 4) wrote {per_file} rows for every file, the same in each;"
        f" call_mods {st['sites']} sites, K1 bf16 launches "
        f"{st['kernel_launches'][K1_BF16]} = 5 x {st['forward_tiles']} "
        f"tiles; phase 6d took {out['seconds']:.1f} s")
    return out


def run_cli_many(runs: list) -> list:
    """Several ``python -m deepsignal_plant_tpu_torch`` invocations, each
    with --verbose_stages, in turn in ONE fresh process (one CUDA start
    and one model load pattern for all: the first run carries CUDA's
    first use). Returns each run's [stages] counters (their launch
    counts are that run's own) plus its wall seconds and output lines."""
    code = ("import json, sys, time\n"
            "from deepsignal_plant_tpu_torch import cli\n"
            "for argv in json.loads(sys.argv[1]):\n"
            "    print('[run] ' + json.dumps(argv), flush=True)\n"
            "    t = time.time()\n"
            "    cli.main(argv + ['--verbose_stages'])\n"
            "    print('[run_seconds] %r' % (time.time() - t), flush=True)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(runs)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        fail("runs {} exited {}:\n{}\n{}".format(
            [r[0] for r in runs], proc.returncode, proc.stdout[-4000:],
            proc.stderr[-4000:]))
    out = []
    for part in proc.stdout.split("[run] ")[1:]:
        lines = part.splitlines()
        stages = [ln for ln in lines if ln.startswith("[stages] ")]
        if len(stages) != 1:
            fail("a run printed no [stages] line:\n" + part[-3000:])
        st = json.loads(stages[0][len("[stages] "):])
        st["wall_seconds"] = float(next(
            ln for ln in lines if ln.startswith("[run_seconds] ")).split()[1])
        st["lines"] = lines
        out.append(st)
    if len(out) != len(runs):
        fail(f"{len(out)} of {len(runs)} runs reported")
    return out


def k1_only(st: dict, what: str) -> None:
    """A bf16 call_mods run launched K1's bfloat16 kernel 5 times per
    forward tile and nothing else."""
    want = {k: 0 for k in st["kernel_launches"]}
    want[K1_BF16] = 5 * st["forward_tiles"]
    if st["kernel_launches"] != want or not st["forward_tiles"]:
        fail(f"{what}: launched {st['kernel_launches']} for "
             f"{st['forward_tiles']} forward tiles (expected {want})")


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def check_npz(base: str, tmp: str, ckpt: str) -> dict:
    """Phase 7: the .npz planes on the first NPZ_READS reads of phase 6
    (bf16, float16 wire unless stated). ``extract`` into a TSV and into
    each container (npz v1, npz_wire v2, npz_packed v3) at --nproc 4,
    rows/s each; ``call_mods`` on the TSV and on each directory (K1 bf16
    5 times per forward tile, rows equal, sorted, to the TSV plane's;
    the engine's sites/s and wire bytes per site); --transfer_dtype int8
    on the v3 directory and on the TSV (launches, bytes per site against
    float16, agreement with float16 on random weights); --device_resident
    always on the TSV and on v3 (bytes = the streaming plane's, sites/s,
    segments, the forward's device time); float32 on v3, kernel against
    plain within P1_TOL_F32 with no call flipped; --profile_dir on one v3
    file (the trace names K1's kernel); ``serve --once`` over one dropped
    v3 .npz (bytes = the CLI's, a .done marker); one epoch of ``train``
    on the v1 directory (K3, K4 and dW_hh 5 times per step)."""
    t_phase = time.time()
    run = os.path.join(base, "run")
    sub = os.path.join(base, "npz_reads")
    os.makedirs(sub)
    for f in sorted(os.listdir(run))[:NPZ_READS]:
        os.symlink(os.path.join(run, f), os.path.join(sub, f))
    tsv = os.path.join(base, "npz_reads.tsv")
    ext = {"tsv": run_extract("-i", sub, "-o", tsv, "--nproc", "4")}
    with open(tsv, "rb") as fh:
        n_rows = sum(chunk.count(b"\n") for chunk in
                     iter(lambda: fh.read(8 << 20), b""))
    dirs = {}
    for fmt in NPZ_FORMATS:
        dirs[fmt] = os.path.join(base, fmt)
        ext[fmt] = run_extract("-i", sub, "-o", dirs[fmt], "--nproc", "4",
                               "--w_format", fmt)
        files = sorted(os.listdir(dirs[fmt]))
        if not files or not all(f.endswith(".npz") for f in files):
            fail(f"extract --w_format {fmt} wrote {files}")
        ext[fmt]["files"] = len(files)
        ext[fmt]["mb"] = sum(os.path.getsize(os.path.join(dirs[fmt], f))
                             for f in files) / 1e6
    ext["tsv"]["mb"] = os.path.getsize(tsv) / 1e6
    for k, e in ext.items():
        e["rows_per_s"] = n_rows / e["seconds"]
        log(f"extract --w_format {k} --nproc 4 on {NPZ_READS} reads: "
            f"{n_rows} rows in {e['seconds']:.2f} s ({e['rows_per_s']:.1f} "
            f"rows/s; process {e['wall_seconds']:.1f} s), "
            f"{e['mb']:.1f} MB" + (f" in {e['files']} files"
                                   if "files" in e else ""))

    ext["npz_packed"]["sha256"] = {
        f: file_digest(os.path.join(dirs["npz_packed"], f))
        for f in sorted(os.listdir(dirs["npz_packed"]))}
    log("extract --w_format npz_packed: the v3 files' sha256 "
        + json.dumps(ext["npz_packed"]["sha256"]))

    out = {k: os.path.join(tmp, f"npz_{k}.calls.tsv") for k in (
        "warm", "tsv", *NPZ_FORMATS, "i8_v3", "i8_tsv", "res_tsv", "res_v3",
        "f32k", "f32p", "prof")}
    v3_file = os.path.join(dirs["npz_packed"],
                           sorted(os.listdir(dirs["npz_packed"]))[0])
    prof_dir = os.path.join(tmp, "npz_prof")
    f32 = ["--compute_dtype", "float32", "--transfer_dtype", "float32"]
    # "warm" first: the process's first run carries CUDA's first use
    plan = [("warm", v3_file, []), ("tsv", tsv, []),
            ("npz", dirs["npz"], []), ("npz_wire", dirs["npz_wire"], []),
            ("npz_packed", dirs["npz_packed"], []),
            ("i8_v3", dirs["npz_packed"], ["--transfer_dtype", "int8"]),
            ("i8_tsv", tsv, ["--transfer_dtype", "int8"]),
            ("res_tsv", tsv, ["--device_resident", "always"]),
            ("res_v3", dirs["npz_packed"], ["--device_resident", "always"]),
            ("f32k", dirs["npz_packed"], f32 + ["--recurrence", "kernel"]),
            ("f32p", dirs["npz_packed"], f32 + ["--recurrence", "scan"]),
            ("prof", v3_file, ["--profile_dir", prof_dir])]
    res = dict(zip([k for k, _, _ in plan], run_cli_many(
        [["call_mods", "-i", inp, "-m", ckpt, "-o", out[k], *extra]
         for k, inp, extra in plan])))
    want = sorted_rows(out["tsv"])
    if len(want) != n_rows:
        fail(f"call_mods on the TSV wrote {len(want)} rows for {n_rows}")
    for k in ("tsv", *NPZ_FORMATS, "i8_v3", "i8_tsv", "res_tsv", "res_v3",
              "prof"):
        k1_only(res[k], f"call_mods {k}")
    planes = {}
    for k in ("tsv", *NPZ_FORMATS):
        st = res[k]
        if sorted_rows(out[k]) != want:
            fail(f"call_mods on {k} wrote rows that differ from the TSV "
                 f"plane's")
        if k != "tsv" and st["npz_version"] != NPZ_FORMATS[k]:
            fail(f"call_mods on {k} read container v{st['npz_version']}")
        planes[k] = {"sites": st["sites"], "sites_per_s": st["sites_per_s"],
                     "seconds": st["seconds"],
                     "wire_bytes_per_site": st["wire_bytes"] / st["sites"],
                     "forward_tiles": st["forward_tiles"],
                     "k1_bf16_launches":
                         st["kernel_launches"][K1_BF16],
                     "route": ("per-site" if st["persite_sites"]
                               else "packed"),
                     **{f: st[f] for f in STAGE_FIELDS}}
        log(f"call_mods on {k} ({st['sites']} sites): "
            f"{st['sites_per_s']:.1f} sites/s in the engine "
            f"({st['seconds']:.3f} s; in-process run "
            f"{st['wall_seconds']:.2f} s), "
            f"{planes[k]['wire_bytes_per_site']:.1f} wire bytes a site on "
            f"the {planes[k]['route']} route, K1 bf16 "
            f"{planes[k]['k1_bf16_launches']} = 5 x {st['forward_tiles']} "
            f"tiles; rows equal, sorted, to the TSV plane's")

    # int8 against float16 (random weights: reported, not gated)
    int8 = {}
    for k, ref in (("i8_v3", "npz_packed"), ("i8_tsv", "tsv")):
        st, rows = res[k], sorted_rows(out[k])
        got = [r.split(b"\t") for r in rows]
        base_rows = [r.split(b"\t") for r in sorted_rows(out[ref])]
        if [g[:6] + g[9:] for g in got] != \
                [b[:6] + b[9:] for b in base_rows]:
            fail(f"int8 run {k} wrote other sites than the float16 run")
        p8 = np.array([float(g[7]) for g in got])
        p16 = np.array([float(b[7]) for b in base_rows])
        if not np.isfinite(p8).all() or (p8 < 0).any() or (p8 > 1).any():
            fail(f"int8 run {k}: probabilities outside [0, 1]")
        int8[k] = {"sites": st["sites"], "sites_per_s": st["sites_per_s"],
                   "wire_bytes_per_site": st["wire_bytes"] / st["sites"],
                   "float16_wire_bytes_per_site":
                       planes[ref]["wire_bytes_per_site"],
                   "agreement": float(np.mean([g[8] == b[8] for g, b in
                                               zip(got, base_rows)])),
                   "max_dp1": float(np.abs(p8 - p16).max()),
                   "k1_bf16_launches":
                       st["kernel_launches"][K1_BF16],
                   "batches": st["batches"],
                   "bases_uploaded": st["bases_uploaded"]}
        log(f"int8 on {ref}: {st['sites_per_s']:.1f} sites/s, "
            f"{int8[k]['wire_bytes_per_site']:.3f} wire bytes a site "
            f"(float16 {int8[k]['float16_wire_bytes_per_site']:.3f}; "
            f"{st['sites']} sites, {st['batches']} batches, "
            f"{st['bases_uploaded']} bases uploaded); "
            f"against float16 agreement {int8[k]['agreement']:.6f}, max "
            f"|dP1| {int8[k]['max_dp1']:.3g} (random weights: P1 ~ 0.5, no "
            f"gate; the trained fixture is the int8 gate)")

    # resident against streaming
    resident = {}
    for k, ref in (("res_tsv", "tsv"), ("res_v3", "npz_packed")):
        st = res[k]
        if read_bytes(out[k]) != read_bytes(out[ref]):
            fail(f"--device_resident always on {ref} wrote other bytes "
                 f"than the streaming plane")
        fwd = st["forward_device_seconds"]
        resident[k] = {"sites": st["sites"],
                       "sites_per_s": st["sites_per_s"],
                       "segments": st["resident_segments"],
                       "k_chunks": st["resident_k_chunks"],
                       "forward_device_seconds": fwd,
                       "compute_window_sites_per_s": st["sites"] / fwd,
                       "upload_device_seconds": st["upload_device_seconds"],
                       "streaming_sites_per_s": planes[ref]["sites_per_s"],
                       "streaming_forward_device_seconds":
                           planes[ref]["forward_device_seconds"]}
        log(f"--device_resident always on {ref}: bytes = the streaming "
            f"plane's; {st['sites_per_s']:.1f} sites/s (streaming "
            f"{planes[ref]['sites_per_s']:.1f}); {st['resident_segments']} "
            f"segment(s) of up to {st['resident_k_chunks']} batches; "
            f"forward {fwd:.4f} s of device time "
            f"({st['sites'] / fwd:.1f} sites/s compute window), upload "
            f"{st['upload_device_seconds']:.4f} s")

    # float32 on v3: kernel against plain
    k_st, p_st = res["f32k"], res["f32p"]
    if any(p_st["kernel_launches"].values()):
        fail("the plain float32 v3 run launched a kernel")
    if f32_layers(k_st) != 5 * k_st["forward_tiles"] or \
            k_st["kernel_launches"][K1_BF16]:
        fail(f"the float32 v3 run launched {k_st['kernel_launches']} for "
             f"{k_st['forward_tiles']} forward tiles")
    k_rows = [r.split(b"\t") for r in read_bytes(out["f32k"]).splitlines()]
    p_rows = [r.split(b"\t") for r in read_bytes(out["f32p"]).splitlines()]
    if len(k_rows) != n_rows or len(p_rows) != n_rows:
        fail("the float32 v3 runs did not call every site")
    for a, b in zip(k_rows, p_rows):
        if a[:6] != b[:6] or a[9] != b[9]:
            fail(f"float32 v3 kernel and plain rows differ: {a} {b}")
    flips = int(sum(a[8] != b[8] for a, b in zip(k_rows, p_rows)))
    dp = max(abs(float(a[7]) - float(b[7])) for a, b in zip(k_rows, p_rows))
    if flips or dp > P1_TOL_F32:
        fail(f"float32 v3 kernel vs plain: {flips} call differences, "
             f"max|dP1| {dp:.3g} (bound {P1_TOL_F32:g})")
    log(f"float32 on v3 ({k_st['sites']} sites): kernel vs plain 0 call "
        f"differences, max|dP1| = {dp:.3g} (bound {P1_TOL_F32:g}); K1 "
        f"float32 layers {f32_layers(k_st)} = 5 x {k_st['forward_tiles']} "
        f"tiles")

    # --profile_dir: the trace names K1's kernel
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".trace.json")]
    if len(traces) != 1:
        fail(f"--profile_dir wrote {traces}")
    with open(os.path.join(prof_dir, traces[0])) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    k1 = sorted(n for n in names if "fused_bilstm_wgmma_kernel" in n)
    stages = sorted(n for n in names if n in (
        "upload", "forward", "readback", "emit"))
    if not k1 or len(stages) != 4:
        fail(f"the trace names no K1 kernel or misses stages: {k1} "
             f"{stages}")
    log(f"--profile_dir: {traces[0]} "
        f"({os.path.getsize(os.path.join(prof_dir, traces[0])) / 1e6:.1f} "
        f"MB, {len(trace['traceEvents'])} events) names {k1[0][:60]} and "
        f"the stages {stages}")

    # serve --once over one dropped v3 .npz
    watch, served = (os.path.join(base, d) for d in ("npz_watch",
                                                     "npz_served"))
    os.makedirs(watch)
    shutil.copy(v3_file, os.path.join(watch, "drop.npz"))
    cli_drop = run_cli_many([["call_mods", "-i",
                              os.path.join(watch, "drop.npz"), "-m", ckpt,
                              "-o", os.path.join(tmp, "drop_cli.tsv")]])[0]
    st = run_cli("serve", "--watch_dir", watch, "--result_dir", served,
                 "--model_path", ckpt, "--once", "--poll_s", "0.2")
    if read_bytes(os.path.join(served, "drop.npz.call_mods.tsv")) != \
            read_bytes(os.path.join(tmp, "drop_cli.tsv")):
        fail("the served calls of the .npz drop differ from the CLI's")
    if not os.path.exists(os.path.join(served, "drop.npz.done")):
        fail("serve left the .npz drop without a .done marker")
    k1_only(st, "serve over the .npz drop")
    req = st["requests"]
    log(f"serve --once over one v3 .npz drop: {req[0]['sites']} sites in "
        f"{req[0]['seconds']:.3f} s ({req[0]['sites_per_s']:.1f} sites/s), "
        f"bytes = the call_mods CLI's ({cli_drop['seconds']:.3f} s in its "
        f"engine), .done written")

    # one epoch of train on the v1 directory
    tr = run_cli("train", "--train_file", dirs["npz"], "--valid_file",
                 dirs["npz"], "--model_dir", os.path.join(tmp, "npz_model"),
                 "--max_epoch_num", "1", "--min_epoch_num", "1",
                 "--step_interval", "100000")
    steps = -(-n_rows // TRAIN_B)
    kl = tr["kernel_launches"]
    want_kl = {k: 0 for k in kl}
    want_kl.update({"lstm_recurrence_fwd_save": 5 * steps,
                    "lstm_recurrence_bwd": 5 * steps,
                    "lstm_dw_hh": 5 * steps,
                    K1_BF16: 5 * tr["eval_tiles"]})
    if tr["steps"] != steps or kl != want_kl or \
            not np.isfinite(tr["step_losses"]).all():
        fail(f"train on the v1 directory: {tr['steps']} steps, launched "
             f"{kl} (expected {steps} steps, {want_kl})")
    log(f"train, one epoch on the v1 .npz directory ({n_rows} rows, "
        f"{tr['plane']} plane): {steps} steps, K3 "
        f"{kl['lstm_recurrence_fwd_save']}, K4 {kl['lstm_recurrence_bwd']}, "
        f"dW_hh {kl['lstm_dw_hh']} = 5 per step; "
        f"{tr['samples_per_s']:.1f} samples/s; read "
        f"{tr['read_seconds']:.2f} s")
    # phase 10 calls the v3 directory after this run is gone
    shutil.copytree(dirs["npz_packed"], os.path.join(tmp, "npz_v3"))
    seconds = time.time() - t_phase
    log(f"phase 7 took {seconds:.1f} s")
    return {"reads": NPZ_READS, "rows": n_rows, "extract": ext,
            "call_mods": planes, "int8": int8, "resident": resident,
            "float32": {"sites": k_st["sites"], "max_dp1": dp,
                        "launches": k_st["kernel_launches"]},
            "serve": {"request": req[0],
                      "wall_seconds": st["wall_seconds"]},
            "train": {"steps": steps, "launches": kl,
                      "plane": tr["plane"],
                      "samples_per_s": tr["samples_per_s"]},
            "seconds": seconds}


def flip_labels(src: str, dst: str, frac: float, seed: int) -> dict:
    """Copy a features TSV with ``frac`` of its label-0 rows labelled 1
    (seeded); returns each row's true label by position (column 2)."""
    rng = np.random.default_rng(seed)
    truth, flipped = {}, 0
    with open(src) as rf, open(dst, "w") as wf:
        for line in rf:
            cols = line.rstrip("\n").split("\t")
            truth[cols[1]] = cols[11]
            if cols[11] == "0" and rng.random() < frac:
                cols[11] = "1"
                flipped += 1
            wf.write("\t".join(cols) + "\n")
    return {"truth": truth, "flipped": flipped}


def label_purity(path: str, truth: dict) -> dict:
    """Rows of each label, and the share of each label's rows whose true
    label it is."""
    n = {"0": 0, "1": 0}
    right = {"0": 0, "1": 0}
    with open(path) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            n[cols[11]] += 1
            right[cols[11]] += truth[cols[1]] == cols[11]
    return {"rows": n["0"] + n["1"], "label1_rows": n["1"],
            "label1_purity": right["1"] / max(n["1"], 1),
            "label0_purity": right["0"] / max(n["0"], 1)}


def run_denoise(tmp: str, name: str, noisy: str, *extra: str) -> dict:
    """One denoise CLI process on a copy of ``noisy`` in its own
    directory; its [stages] counters, the final file's bytes and the
    first iteration's mean scores."""
    d = os.path.join(tmp, name)
    os.makedirs(d)
    src = os.path.join(d, "noisy.tsv")
    shutil.copy(noisy, src)
    st = run_cli("denoise", "--train_file", src, "--fst_iter_prob",
                 *DENOISE_ARGS, *extra)
    st["bytes"] = read_bytes(st["final_file"])
    with open(src + ".probs_1stiter.txt") as fh:
        st["scores"] = np.array([float(ln.split("\t")[1]) for ln in fh])
    log(f"denoise {name}: " + json.dumps(
        {k: v for k, v in st.items() if k not in ("bytes", "scores")}))
    return st


def check_launches(what: str, got: dict, want: dict) -> None:
    full = {k: 0 for k in got}
    full.update(want)
    if got != full:
        fail(f"{what} launched {got}, expected {full}")


def check_denoise_resume_stream(tmp: str, ab) -> dict:
    """Phase 8: denoise at the CLI's defaults (bf16, signal_bilstm) on a
    20%-flipped learnable TSV, then in float32 through the kernels and
    through the plain versions; train one epoch, --resume to two, and
    one epoch on the streamed plane. Every step is a fresh CLI process
    whose launch counts start at 0."""
    t_phase = time.time()
    clean = os.path.join(tmp, "denoise_clean.tsv")
    noisy = os.path.join(tmp, "denoise_noisy.tsv")
    ab.write_features(clean, DENOISE_ROWS, SEED + 8, DENOISE_SHIFT)
    flip = flip_labels(clean, noisy, DENOISE_FLIP, SEED + 9)
    before = label_purity(noisy, flip["truth"])

    bf = run_denoise(tmp, "denoise_bf16", noisy)
    if (bf["compute_dtype"], bf["recurrence"]) != ("bfloat16", "kernel"):
        fail(f"denoise defaults did not run bf16 kernels: {bf}")
    check_launches("denoise (bf16)", bf["kernel_launches"], {
        "lstm_recurrence_fwd_save": DENOISE_LAYERS * bf["steps"],
        "lstm_recurrence_bwd": DENOISE_LAYERS * bf["steps"],
        "lstm_dw_hh": DENOISE_LAYERS * bf["steps"],
        K1_BF16: DENOISE_LAYERS * bf["forward_tiles"]})
    after = label_purity(bf["final_file"], flip["truth"])
    log(f"denoise purity on {DENOISE_ROWS} rows ({flip['flipped']} labels "
        f"flipped): label-1 {before['label1_purity']:.4%} -> "
        f"{after['label1_purity']:.4%}, label-0 "
        f"{before['label0_purity']:.4%} -> {after['label0_purity']:.4%}, "
        f"{after['rows']} rows kept; {bf['mini_trainings']} mini-trainings "
        f"({bf['resident_trainings']} resident), {bf['steps']} steps, "
        f"{bf['forward_tiles']} forward tiles in {bf['seconds']:.2f} s "
        f"({bf['wall_seconds']:.2f} s with the process)")
    if not after["label1_purity"] > before["label1_purity"]:
        fail("denoise did not raise label-1 purity")

    # float32, kernels against plain versions, dropout 0
    f32 = {rec: run_denoise(tmp, f"denoise_f32_{rec}", noisy,
                            "--compute_dtype", "float32", "--dropout_rate",
                            "0", "--recurrence", rec)
           for rec in ("kernel", "scan")}
    k, p = f32["kernel"], f32["scan"]
    k1_f32 = k1_f32_layers(k["kernel_launches"])
    if (k["kernel_launches"]["lstm_recurrence_fwd_save_f32"]
            != DENOISE_LAYERS * k["steps"]
            or k["kernel_launches"]["lstm_recurrence_bwd_f32"]
            != DENOISE_LAYERS * k["steps"]
            or k1_f32 != DENOISE_LAYERS * k["forward_tiles"]):
        fail(f"float32 denoise launched {k['kernel_launches']} for "
             f"{k['steps']} steps and {k['forward_tiles']} tiles")
    check_launches("float32 denoise (plain)", p["kernel_launches"], {})
    dscore = float(np.abs(k["scores"] - p["scores"]).max())
    margin = float(np.abs(p["scores"] - 0.5).min())
    log(f"float32 denoise, kernel vs plain: max |d mean score| "
        f"{dscore:.3g} (tolerance {DENOISE_SCORE_TOL:g}; the plain run's "
        f"smallest |mean - 0.5| {margin:.3g}); final files "
        f"{'equal' if k['bytes'] == p['bytes'] else 'DIFFER'}; "
        f"{k['seconds']:.2f} s vs {p['seconds']:.2f} s")
    if dscore > DENOISE_SCORE_TOL or k["bytes"] != p["bytes"]:
        fail("float32 denoise through the kernels and the plain versions "
             "disagree")

    # train 1 epoch, --resume to 2, and 1 epoch streamed (phase 4b's rows)
    common = ("--train_file", os.path.join(tmp, "train.tsv"),
              "--valid_file", os.path.join(tmp, "valid.tsv"),
              "--step_interval", "100000", "--min_epoch_num", "2")
    resumed = ("--model_dir", os.path.join(tmp, "resume_model"))
    steps = -(-TRAIN_ROWS // TRAIN_B)
    # the first epoch and the streamed one in turn in one process; the
    # resumed run in a fresh process, from the state file alone
    runs = dict(zip(("epoch1", "stream"), run_cli_many([
        ["train", *common, *resumed, "--max_epoch_num", "1"],
        ["train", *common, "--model_dir", os.path.join(tmp, "stream_model"),
         "--max_epoch_num", "1", "--stream", "yes"]])))
    runs["resume"] = run_cli("train", *common, *resumed, "--max_epoch_num",
                             "2", "--resume")
    for name, st in runs.items():
        start = (1, steps) if name == "resume" else (0, 0)
        plane = "stream" if name == "stream" else "resident"
        ran = st["steps"] - st["start_step"]
        check_launches(f"train ({name})", st["kernel_launches"], {
            "lstm_recurrence_fwd_save": 5 * ran,
            "lstm_recurrence_bwd": 5 * ran, "lstm_dw_hh": 5 * ran,
            K1_BF16: 5 * st["eval_tiles"]})
        if ((st["start_epoch"], st["start_step"]) != start or ran != steps
                or st["plane"] != plane
                or not np.isfinite(st["step_losses"]).all()):
            fail(f"train ({name}): started at epoch {st['start_epoch']} "
                 f"step {st['start_step']}, ran {ran} steps on the "
                 f"{st['plane']} plane (expected {start}, {steps}, {plane})")
        log(f"train ({name}, {st['plane']}): epoch {st['start_epoch'] + 1}, "
            f"steps {st['start_step'] + 1}-{st['steps']}, "
            f"{st['samples_per_s']:.1f} samples/s, valid accuracy "
            f"{st['valid_accuracies']}, read {st['read_seconds']:.2f} s, "
            f"wall {st['wall_seconds']:.2f} s")
    seconds = time.time() - t_phase
    log(f"phase 8 took {seconds:.1f} s")
    keep = ("steps", "forward_tiles", "mini_trainings", "resident_trainings",
            "accuracy_checks", "score_tiles", "kernel_launches", "seconds",
            "train_seconds", "score_seconds", "mini_trainings_per_s",
            "samples_per_s", "wall_seconds", "iterations_run")
    return {"rows": DENOISE_ROWS, "flipped": flip["flipped"],
            "purity_before": before, "purity_after": after,
            "bf16": {k_: bf[k_] for k_ in keep},
            "float32": {"max_abs_dscore": dscore, "margin": margin,
                        "same_file": k["bytes"] == p["bytes"],
                        "kernel": {k_: k[k_] for k_ in keep},
                        "plain": {k_: p[k_] for k_ in keep}},
            "train": {name: {k_: st[k_] for k_ in (
                "plane", "start_epoch", "start_step", "steps",
                "kernel_launches", "samples_per_s", "train_seconds",
                "eval_seconds", "read_seconds", "valid_accuracies",
                "wall_seconds")} for name, st in runs.items()},
            "seconds": seconds}


def check_denoise_ranks(tmp: str) -> dict:
    """Phase 8b: ``denoise`` at RANKS ranks on card 0 over gloo, one
    launch running both planes in turn: the global-batch plane (float32,
    dropout 0, DENOISE_RANK_ROWS rows; its final file and mean scores
    against one process's at the same batch) and the sharded-resident
    plane (the CLI's defaults, DSP_DENOISE_RESIDENT_MIN_ROWS=0, phase
    8's file and arguments; label-1 purity), each rank's
    launches against its steps and tiles, files from rank 0 only, the
    same halves on every rank; then one NCCL rank under
    torch.distributed.run writing one process's file byte for byte."""
    t_phase = time.time()
    noisy = os.path.join(tmp, "denoise_noisy.tsv")
    cut = os.path.join(tmp, "denoise_cut.tsv")
    truth = {}
    with open(noisy) as rf, open(cut, "w") as wf:
        for _, line in zip(range(DENOISE_RANK_ROWS), rf):
            wf.write(line)
    with open(os.path.join(tmp, "denoise_clean.tsv")) as rf:
        for line in rf:
            cols = line.rstrip("\n").split("\t")
            truth[cols[1]] = cols[11]
    f32 = ("--compute_dtype", "float32", "--dropout_rate", "0")

    def copy_to(name: str, src: str = cut) -> tuple[str, str]:
        d = os.path.join(tmp, name)
        os.makedirs(d)
        shutil.copy(src, os.path.join(d, "noisy.tsv"))
        return d, os.path.join(d, "noisy.tsv")

    # name -> (input, arguments, DSP_DENOISE_RESIDENT_MIN_ROWS)
    planes = {"global": (cut, (*DENOISE_RANK_ARGS, *f32), "100000"),
              "sharded": (noisy, DENOISE_ARGS, "0")}
    runs, dirs = [], {}
    for name, (src, extra, min_rows) in planes.items():
        dirs[name] = copy_to(f"ranks_denoise_{name}", src)
        runs.append([
            os.path.join(tmp, f"ranks_denoise_{name}_rank") + "{rank}.npz",
            ["denoise", "--train_file", dirs[name][1], "--fst_iter_prob",
             *extra, "--device", "cuda:0", "--verbose_stages"],
            {"watch": dirs[name][0],
             "env": {"DSP_DENOISE_RESIDENT_MIN_ROWS": min_rows}}])
    t0 = time.time()
    outs = rank_runs(runs)
    out = {"launch_seconds": time.time() - t0}
    for (name, (src, extra, _)), run_outs in zip(planes.items(), outs):
        f32_run = "float32" in extra
        before = label_purity(src, truth)
        sts = rank_stages(run_outs)
        res = []
        for r in range(RANKS):
            with np.load(os.path.join(
                    tmp, f"ranks_denoise_{name}_rank{r}.npz")) as z:
                res.append(json.loads(z["result"].tobytes()))
        sharded = name == "sharded"
        for r, st in enumerate(sts):
            if (st["rank"], st["world_size"], st["local_batch"],
                    st["sharded_trainings"]) != (
                    r, RANKS, TRAIN_B // RANKS,
                    st["mini_trainings"] if sharded else 0):
                fail(f"denoise rank {r} ({name}): {st}")
            layers = DENOISE_LAYERS
            if f32_run:
                k1 = k1_f32_layers(st["kernel_launches"])
                want = {"lstm_recurrence_fwd_save_f32": layers * st["steps"],
                        "lstm_recurrence_bwd_f32": layers * st["steps"],
                        "lstm_dw_hh": layers * st["steps"]}
                got = {k: st["kernel_launches"][k] for k in want}
                if got != want or k1 != layers * st["forward_tiles"]:
                    fail(f"denoise rank {r} ({name}) launched "
                         f"{st['kernel_launches']} for {st['steps']} steps "
                         f"and {st['forward_tiles']} forward tiles")
            else:
                check_launches(f"denoise rank {r} ({name})",
                               st["kernel_launches"], {
                    "lstm_recurrence_fwd_save": layers * st["steps"],
                    "lstm_recurrence_bwd": layers * st["steps"],
                    "lstm_dw_hh": layers * st["steps"],
                    K1_BF16: layers * st["forward_tiles"]})
        if any(x["draws"] != res[0]["draws"] for x in res) or any(
                x["final"] != res[0]["final"] for x in res):
            fail(f"denoise ({name}): the ranks drew or ended apart: {res}")
        if not res[0]["writes"] or any(x["writes"] for x in res[1:]):
            fail(f"denoise ({name}): rank 0 wrote {res[0]['writes']}, the "
                 f"others {[x['writes'] for x in res[1:]]}")
        with open(dirs[name][1] + ".probs_1stiter.txt") as fh:
            scores = np.array([float(ln.split("\t")[1]) for ln in fh])
        out[name] = {"ranks": [{k: st[k] for k in (
            "steps", "forward_tiles", "accuracy_checks", "score_tiles",
            "train_rows", "mini_trainings", "sharded_trainings",
            "iterations_run",
            "kernel_launches", "seconds", "train_seconds", "score_seconds",
            "mini_trainings_per_s", "samples_per_s")} for st in sts],
            "final": res[0]["final"], "scores": scores,
            "bytes": read_bytes(res[0]["final"]),
            "rows": before["rows"], "purity_before": before,
            "purity": label_purity(res[0]["final"], truth)}
        log(f"denoise at {RANKS} ranks on card 0 over gloo ({name} plane, "
            f"{'float32, dropout 0' if f32_run else 'bf16, dropout 0.5'}, "
            f"{before['rows']} rows, {sts[0]['iterations_run']} "
            f"iteration(s)): {sts[0]['steps']} steps of {TRAIN_B // RANKS} "
            f"rows a rank, "
            f"per rank " + ", ".join(
                f"{st['seconds']:.2f} s ({st['mini_trainings_per_s']:.3f} "
                f"mini-trainings/s, {st['forward_tiles']} forward tiles)"
                for st in sts)
            + f"; label-1 purity {before['label1_purity']:.4%} -> "
            f"{out[name]['purity']['label1_purity']:.4%}; the same halves "
            f"on every rank, files from rank 0 only")
    if out["sharded"]["purity"]["label1_purity"] < DENOISE_PURITY:
        fail(f"denoise on the sharded plane reached label-1 purity "
             f"{out['sharded']['purity']['label1_purity']} (gate "
             f"{DENOISE_PURITY})")

    # one process at the same batch, and one NCCL rank, on the global
    # plane's arguments
    d, src = copy_to("one_denoise")
    one = run_cli("denoise", "--train_file", src, "--fst_iter_prob",
                  *DENOISE_RANK_ARGS, *f32)
    with open(src + ".probs_1stiter.txt") as fh:
        one_scores = np.array([float(ln.split("\t")[1]) for ln in fh])
    g = out["global"]
    dscore = float(np.abs(g["scores"] - one_scores).max())
    margin = float(np.abs(one_scores - 0.5).min())
    same = g["bytes"] == read_bytes(one["final_file"])
    log(f"denoise, global-batch plane at {RANKS} ranks against one process "
        f"at batch {TRAIN_B} (float32): max |d mean score| {dscore:.3g} "
        f"(tolerance {DENOISE_RANK_SCORE_TOL:g}; one process's smallest "
        f"|mean - 0.5| {margin:.3g}); final files "
        f"{'equal' if same else 'DIFFER'}; one process "
        f"{one['seconds']:.2f} s ({one['mini_trainings_per_s']:.3f} "
        f"mini-trainings/s; {one['wall_seconds']:.2f} s with the process), "
        f"two ranks {max(st['seconds'] for st in g['ranks']):.2f} s")
    if dscore > DENOISE_RANK_SCORE_TOL or not same:
        fail("denoise at two ranks and in one process disagree")
    nd, nsrc = copy_to("nccl_denoise")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__),
           "--nccl-worker", "denoise", "--train_file", nsrc,
           "--fst_iter_prob", *DENOISE_RANK_ARGS, *f32, "--verbose_stages"]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0 or "NCCL collectives ok" not in proc.stdout:
        fail(f"the NCCL denoise exited {proc.returncode}:\n"
             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    nst = rank_stages([proc.stdout])[0]
    nccl_same = read_bytes(nst["final_file"]) == read_bytes(
        one["final_file"])
    log(f"denoise under torch.distributed.run --nproc_per_node 1 (NCCL): "
        f"{nst['seconds']:.2f} s, {time.time() - t0:.1f} s with the "
        f"launcher; final file {'equal to' if nccl_same else 'DIFFERS from'}"
        f" one process's, byte for byte")
    if not nccl_same:
        fail("the NCCL rank's denoise file differs from one process's")
    for name, (src, extra, min_rows) in planes.items():
        # phase 11 runs the same denoise over two replicas on card 0
        out[name]["final_sha256"] = hashlib.sha256(
            out[name].pop("bytes")).hexdigest()
        out[name]["input"] = {"train_file": src, "args": list(extra),
                              "min_rows": min_rows}
        del out[name]["scores"]
    out.update({"one_process": {k: one[k] for k in (
        "seconds", "wall_seconds", "mini_trainings_per_s", "steps",
        "forward_tiles", "kernel_launches")},
        "global_vs_one": {"max_abs_dscore": dscore, "margin": margin,
                          "same_file": same},
        "nccl": {"seconds": nst["seconds"], "same_file": nccl_same,
                 "kernel_launches": nst["kernel_launches"]}})
    out["seconds"] = time.time() - t_phase
    log(f"phase 8b (denoise) took {out['seconds']:.1f} s")
    return out


def check_resnet(torch, cuda_ms) -> dict:
    """Phase 8b, ResNet3 (models/resnet1d.py) at the reference's widths
    on a (RESNET_BATCH, 1, RESNET_LEN) input, its weights from one seeded
    generator: training mode (outputs and the running statistics it
    moves), then eval mode with those statistics, on the card with TF32
    off against the CPU within RESNET_TOL; the same with TF32 on
    (PyTorch's default for cuDNN convolutions) is reported beside."""
    import copy
    from deepsignal_plant_tpu_torch.models import resnet1d
    cpu = resnet1d.init_resnet3(torch.Generator().manual_seed(SEED),
                                RESNET_OUT)
    card = {tf32: resnet1d.resnet3_from_state_dict(cpu.state_dict(),
                                                   device="cuda")
            for tf32 in (False, True)}
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(RESNET_BATCH, 1, RESNET_LEN)).astype(np.float32))
    xc = x.cuda()
    out = {"shape": list(x.shape), "tolerance": RESNET_TOL}
    for mode in ("train", "eval"):
        cpu.train(mode == "train")
        with torch.no_grad():
            want = cpu(x)
            for tf32, m in card.items():
                m.train(mode == "train")
                with torch.backends.cudnn.flags(enabled=True,
                                                allow_tf32=tf32):
                    got = m(xc).cpu()
                key = f"{mode}_tf32" if tf32 else mode
                out[key] = float((got - want).abs().max())
                if mode == "train":
                    sd = cpu.state_dict()
                    out[key + "_stats"] = max(
                        float((v.cpu().double() - sd[k].double()).abs().max())
                        for k, v in m.state_dict().items())
        if tuple(want.shape) != (RESNET_BATCH, RESNET_OUT,
                                 resnet1d.get_lout(RESNET_LEN, (1, 2, 2))):
            fail(f"ResNet3 gave shape {tuple(want.shape)}")
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        out["eval_ms"] = cuda_ms(torch, lambda: card[False](xc))
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=True):
        out["eval_tf32_ms"] = cuda_ms(torch, lambda: card[True](xc))
    log("ResNet3 (out 128, strides (1, 2, 2)) on a "
        f"{tuple(x.shape)} input, card against CPU: " + json.dumps(out))
    if max(out["train"], out["train_stats"], out["eval"]) > RESNET_TOL:
        fail(f"ResNet3 on the card disagrees with the CPU beyond "
             f"{RESNET_TOL} with TF32 off: {out}")
    return out


def phase8b_launches(phase8b: dict, name: str) -> dict:
    """A kernel's launches in phase 8b's runs: each rank of each plane,
    and the one-process and NCCL runs."""
    runs = {f"{plane}_rank{r}": st for plane in ("global", "sharded")
            for r, st in enumerate(phase8b[plane]["ranks"])}
    runs["one_process"] = phase8b["one_process"]
    runs["nccl"] = phase8b["nccl"]
    return {k: v["kernel_launches"][name] for k, v in runs.items()
            if v["kernel_launches"].get(name)}


def phase8_launches(phase8: dict, name: str) -> dict:
    """A kernel's launches in phase 8's runs: the bf16 and float32
    denoise, and train's resumed and streamed epochs."""
    runs = {"denoise": phase8["bf16"],
            "denoise_float32": phase8["float32"]["kernel"],
            **{f"train_{k}": v for k, v in phase8["train"].items()}}
    return {k: v["kernel_launches"][name] for k, v in runs.items()
            if v["kernel_launches"].get(name)}


def spill_budget(wire: str) -> int:
    """DSP_RESIDENT_MAX_BYTES that cuts the training rows into slabs of
    SPILL_SLAB_ROWS on ``wire`` beside the SPILL_VALID_ROWS valid set:
    the plane gives a slab (budget - 2 * valid bytes) // 3 wire bytes."""
    bpr = WIRE_ROW_BYTES[wire]
    return (2 * SPILL_VALID_ROWS * HOST_ROW_BYTES
            + 3 * (SPILL_SLAB_ROWS * bpr + bpr // 2))


def check_spill(tmp: str, trained: dict) -> dict:
    """Phase 9a: the train CLI on the spill plane at float16 and int8, 2
    epochs of phase 4b's rows, each a fresh process."""
    tr, va = os.path.join(tmp, "train.tsv"), os.path.join(tmp, "valid.tsv")
    sva = os.path.join(tmp, "spill_valid.tsv")
    with open(va) as src, open(sva, "w") as dst:
        for _ in range(SPILL_VALID_ROWS):
            dst.write(src.readline())
    steps = 2 * -(-TRAIN_ROWS // TRAIN_B)
    slabs = -(-TRAIN_ROWS // SPILL_SLAB_ROWS)
    out = {}
    for wire in ("float16", "int8"):
        budget = spill_budget(wire)
        st = run_cli("train", "--train_file", tr, "--valid_file", sva,
                     "--model_dir", os.path.join(tmp, f"spill_{wire}"),
                     "--max_epoch_num", "2", "--step_interval", "16",
                     env={"DSP_RESIDENT_MAX_BYTES": str(budget),
                          "DSP_TRAIN_SPILL_WIRE": wire})
        sp = st["spill"] or {}
        if (st["plane"], sp.get("wire"), sp.get("slabs"),
                sp.get("slab_rows"), st["steps"]) != (
                "spill", wire, slabs, SPILL_SLAB_ROWS, steps):
            fail(f"train with DSP_RESIDENT_MAX_BYTES={budget} on the {wire} "
                 f"wire: {st['plane']} plane, {sp}, {st['steps']} steps "
                 f"(expected spill, {slabs} slabs of {SPILL_SLAB_ROWS} "
                 f"rows, {steps} steps)")
        check_launches(f"train (spill, {wire})", st["kernel_launches"], {
            "lstm_recurrence_fwd_save": 5 * steps,
            "lstm_recurrence_bwd": 5 * steps, "lstm_dw_hh": 5 * steps,
            K1_BF16: 5 * st["eval_tiles"]})
        acc = max(st["valid_accuracies"])
        if not np.isfinite(st["step_losses"]).all() or abs(
                acc - trained["best_valid_accuracy"]) > SPILL_ACC_TOL:
            fail(f"spill ({wire}): valid accuracy {acc} against the "
                 f"resident plane's {trained['best_valid_accuracy']} "
                 f"(tolerance {SPILL_ACC_TOL})")
        out[wire] = {k: st[k] for k in (
            "spill", "steps", "eval_tiles", "kernel_launches",
            "samples_per_s", "train_seconds", "eval_seconds",
            "epoch_train_seconds", "valid_accuracies", "wall_seconds")}
        out[wire]["budget"] = budget
        log(f"train on the spill plane ({wire} wire, budget {budget} bytes):"
            f" {sp['slabs']} slabs of {sp['slab_rows']} rows, "
            f"{sp['slab_uploads']} slab uploads, {sp['wire_bytes'] / 1e6:.1f}"
            f" MB on the wire in {sp['upload_seconds']:.3f} s on the "
            f"prefetch thread against {st['train_seconds']:.3f} s of steps; "
            f"{st['samples_per_s']:.1f} samples/s (resident, phase 4b: "
            f"{trained['samples_per_s']:.1f}); epochs "
            f"{[round(x, 3) for x in st['epoch_train_seconds']]} s; best "
            f"valid accuracy {acc:.4f} on {SPILL_VALID_ROWS} rows (resident "
            f"{trained['best_valid_accuracy']:.4f} on {VALID_ROWS})")
    return out


def torch_launch():
    """tests/torch_launch.py: the launcher the port's tests start ranks
    with, and the one-rank group check."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_launch as tl
    return tl


def launch_ranks(argv: list, world: int = RANKS) -> list:
    """``argv`` as ``world`` ranks on this host, as torchrun starts them
    (tests/torch_launch.launch); each rank's output. A rank that fails
    fails the run."""
    outs = torch_launch().launch(argv, world, timeout=600)
    for r, (rc, o) in enumerate(outs):
        if rc != 0:
            fail(f"rank {r} exited {rc}:\n{o[-4000:]}")
    return [o for _, o in outs]


def rank_stages(outs: list) -> list:
    """Each rank's [stages] counters."""
    got = []
    for r, o in enumerate(outs):
        lines = [ln for ln in o.splitlines() if ln.startswith("[stages] ")]
        if len(lines) != 1:
            fail(f"rank {r} printed no [stages] line:\n{o[-3000:]}")
        got.append(json.loads(lines[0][len("[stages] "):]))
    return got


def rank_runs(runs: list) -> list:
    """``runs`` ([params file or None, CLI argv] each) in turn by RANKS
    ranks on card 0 over gloo: one launch of tests/torch_launch.py as a
    rank, the group started once. Per run, each rank's part of its
    output."""
    outs = launch_ranks(torch_launch().rank_runs(runs))
    parts = [o.split("[rank] run ")[1:] for o in outs]
    if any(len(p) != len(runs) for p in parts):
        fail("a rank did not reach every run:\n" + outs[0][-3000:])
    return [[p[i] for p in parts] for i in range(len(runs))]


def check_ranks(tmp: str, trained: dict, ckpt: str) -> dict:
    """Phase 9b: two ranks on card 0 over gloo (an explicit device and
    backend: NCCL puts no two ranks on one card), in one launch. One
    epoch of full-width training on the sharded-resident and the
    host-fed plane: the ranks' parameters bitwise equal, files from rank
    0 only, 5 launches of K3, K4 and dW_hh a step on each rank; the
    fused fast5 call_mods on phase 6's 64 reads, the union of the ranks'
    .host<N> files equal, sorted, to one process's rows; pod call_freq
    over those files equal to one process's."""
    t_phase = time.time()
    tr, va = os.path.join(tmp, "train.tsv"), os.path.join(tmp, "valid.tsv")
    local_b = TRAIN_B // RANKS
    shard = -(-TRAIN_ROWS // RANKS)         # the most rows a rank holds
    steps = -(-shard // local_b)
    dev = ["--device", "cuda:0"]
    planes = (("sharded", "auto"), ("host-fed", "never"))
    calls = os.path.join(tmp, "ranks_calls.tsv")
    hosts = [os.path.join(tmp, f"ranks_calls.host{r}.tsv")
             for r in range(RANKS)]
    freq = os.path.join(tmp, "ranks_freq.tsv")
    runs = [[os.path.join(tmp, f"ranks_{plane}", "params{rank}.npz"),
             ["train", "--train_file", tr, "--valid_file", va, "--model_dir",
              os.path.join(tmp, f"ranks_{plane}", "m{rank}"),
              "--max_epoch_num", "1", "--min_epoch_num", "1",
              "--step_interval", "100000", "--device_resident", resident,
              *dev, "--verbose_stages"]] for plane, resident in planes]
    runs.append([None, ["call_mods", "-i", os.path.join(tmp, "fast5_sub"),
                        "-m", ckpt, "-o", calls, *dev, "--verbose_stages"]])
    runs.append([None, ["call_freq", *sum((["-i", h] for h in hosts), []),
                        "-o", freq, "--sort", "--prob_cf", "0",
                        "--device_agg", *dev]])
    for plane, _ in planes:
        os.makedirs(os.path.join(tmp, f"ranks_{plane}"))
    outs = rank_runs(runs)
    out = {"train": {}, "launch_seconds": time.time() - t_phase,
           "params": {}}

    for (plane, _), run_outs in zip(planes, outs):
        d = os.path.join(tmp, f"ranks_{plane}")
        out["params"][plane] = os.path.join(d, "params0.npz")
        sts = rank_stages(run_outs)
        for r, st in enumerate(sts):
            if (st["plane"], st["rank"], st["world_size"], st["local_batch"],
                    st["steps"]) != (plane, r, RANKS, local_b, steps):
                fail(f"rank {r} trained {st['plane']} (rank {st['rank']} of "
                     f"{st['world_size']}, {st['local_batch']} rows a step, "
                     f"{st['steps']} steps; expected {plane}, {local_b}, "
                     f"{steps})")
            check_launches(f"rank {r} ({plane})", st["kernel_launches"], {
                "lstm_recurrence_fwd_save": 5 * steps,
                "lstm_recurrence_bwd": 5 * steps, "lstm_dw_hh": 5 * steps,
                K1_BF16: 5 * st["eval_tiles"]})
        params = []
        for r in range(RANKS):
            with np.load(os.path.join(d, f"params{r}.npz")) as z:
                params.append({k: z[k] for k in z.files
                               if k.startswith("params/")})
        if sorted(params[0]) != sorted(params[1]) or any(
                not np.array_equal(params[0][k], params[1][k])
                for k in params[0]):
            fail(f"the ranks' parameters differ after a {plane} epoch")
        written = [sorted(os.listdir(os.path.join(d, f"m{r}")))
                   for r in range(RANKS)]
        if written[1] or "both_bilstm.train_state.npz" not in written[0]:
            fail(f"{plane}: rank 0 wrote {written[0]}, rank 1 {written[1]}")
        if sts[0]["valid_accuracies"] != sts[1]["valid_accuracies"]:
            fail(f"{plane}: the ranks evaluated apart: "
                 f"{[s['valid_accuracies'] for s in sts]}")
        out["train"][plane] = [{k: st[k] for k in (
            "kernel_launches", "eval_tiles", "train_rows", "samples_per_s",
            "train_seconds", "eval_seconds", "epoch_train_seconds",
            "valid_accuracies", "read_seconds")} for st in sts]
        log(f"train at {RANKS} ranks on card 0 over gloo, {plane} plane: "
            f"{steps} steps of {local_b} rows a rank, parameters bitwise "
            f"equal, files from rank 0 only ({written[0]}); per rank "
            + ", ".join(f"{st['samples_per_s']:.1f} samples/s "
                        f"({st['train_rows']} rows in "
                        f"{st['train_seconds']:.3f} s)" for st in sts)
            + f"; valid accuracy {sts[0]['valid_accuracies']}")

    # fused fast5 call_mods on phase 6's 64 reads, then pod call_freq
    sts = rank_stages(outs[2])
    for r, st in enumerate(sts):
        check_launches(f"call_mods rank {r}", st["kernel_launches"],
                       {K1_BF16: 5 * st["forward_tiles"]})
    one = os.path.join(tmp, "f5_sub_cli.tsv")   # phase 6, one process
    merged = sorted(ln for h in hosts for ln in open(h).read().splitlines())
    if os.path.exists(calls) or merged != sorted(
            open(one).read().splitlines()):
        fail("the ranks' call_mods rows differ from one process's")
    out["call_mods"] = [{k: st[k] for k in ("sites", "forward_tiles",
                                            "fast5_files", "sites_per_s",
                                            "seconds", "kernel_launches")}
                        for st in sts]
    log(f"call_mods at {RANKS} ranks on {FAST5_SUB_READS} fast5s: "
        + ", ".join(f"rank {r} {st['fast5_files']} files, {st['sites']} "
                    f"sites, {st['sites_per_s']:.1f} sites/s"
                    for r, st in enumerate(sts))
        + "; the .host<N> files hold one process's rows (phase 6)")
    if "shared input list" not in outs[3][0]:
        fail("pod call_freq did not see a shared list:\n"
             + outs[3][0][-2000:])
    from deepsignal_plant_tpu_torch import cli
    one_freq = os.path.join(tmp, "ranks_freq_one.tsv")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["call_freq", *sum((["-i", h] for h in hosts), []), "-o",
                  one_freq, "--sort", "--prob_cf", "0"])
    if not os.path.getsize(one_freq) or read_bytes(freq) != read_bytes(
            one_freq):
        fail("pod call_freq differs from one process's call_freq")
    log(f"pod call_freq at {RANKS} ranks (--prob_cf 0: every call of the "
        f"random checkpoint counts; --device_agg on card 0, the merge on "
        f"rank 0): {os.path.getsize(freq)} bytes, equal to one process's")
    out["seconds"] = time.time() - t_phase
    return out


def check_nccl(tmp: str) -> dict:
    """Phase 9c: under ``torch.distributed.run --nproc_per_node 1``, a
    one-rank NCCL group on card 0 (nccl_worker): the train step through
    it against the step without it, then 1 epoch of phase 4b's rows by
    the train CLI in it."""
    tr, va = os.path.join(tmp, "train.tsv"), os.path.join(tmp, "valid.tsv")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__),
           "--nccl-worker", "train", "--train_file", tr, "--valid_file", va,
           "--model_dir", os.path.join(tmp, "nccl_model"), "--max_epoch_num",
           "1", "--min_epoch_num", "1", "--step_interval", "100000",
           "--verbose_stages"]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0 or "NCCL collectives ok" not in proc.stdout:
        fail(f"the NCCL run exited {proc.returncode}:\n"
             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    step = json.loads(next(
        ln for ln in proc.stdout.splitlines()
        if ln.startswith("NCCL step check: "))[len("NCCL step check: "):])
    st = rank_stages([proc.stdout])[0]
    steps = -(-TRAIN_ROWS // TRAIN_B)
    if (st["plane"], st["world_size"], st["steps"]) != ("resident", 1,
                                                        steps):
        fail(f"the NCCL run trained {st['plane']} at world size "
             f"{st['world_size']}, {st['steps']} steps")
    check_launches("train (torchrun, NCCL)", st["kernel_launches"], {
        "lstm_recurrence_fwd_save": 5 * steps,
        "lstm_recurrence_bwd": 5 * steps, "lstm_dw_hh": 5 * steps,
        K1_BF16: 5 * st["eval_tiles"]})
    log(f"NCCL group of one rank on card 0 (parallel.dist.start_group): "
        f"the train step through it is the step without it, bitwise (loss "
        f"{step['loss']:.6f}, evaluation {step['eval']}); with "
        f"{step['rows'] - step['kept']} of {step['rows']} rows padded and "
        f"masked, max|update - update on the {step['kept']} rows kept| = "
        f"{step['masked_update_err']:.3g} of {step['update_scale']:.3g} "
        f"(tolerance {NCCL_UPDATE_TOL:g}), loss {step['masked_loss']:.6f} "
        f"against {step['kept_loss']:.6f}")
    log(f"train under torch.distributed.run --nproc_per_node 1 (every step "
        f"and evaluation all-reducing over NCCL): "
        f"{st['samples_per_s']:.1f} samples/s, {time.time() - t0:.1f} s "
        f"with the launcher")
    return {"step_check": step, **{k: st[k] for k in (
        "kernel_launches", "samples_per_s", "train_seconds",
        "valid_accuracies")}}


def nccl_worker(argv: list) -> int:
    """``--nccl-worker <cli argv>`` under torch.distributed.run with one
    process (phase 9c): parallel.dist.start_group starts the NCCL group
    of that rank on its card (the branch init_distributed takes under a
    launch of more than one rank), the train step and the evaluation
    through it are held against the same calls before it started
    (tests/torch_launch.one_rank_group_check: at full width in bfloat16,
    a rank's 256 rows), the port's collectives run on the card, then the
    CLI command runs in the group: its steps and evaluations all-reduce
    over NCCL."""
    import torch
    sys.path.insert(0, REPO)
    from deepsignal_plant_tpu_torch import cli
    from deepsignal_plant_tpu_torch.config import ModelConfig
    from deepsignal_plant_tpu_torch.parallel import dist, multihost
    if os.environ.get("WORLD_SIZE") != "1":
        fail("the NCCL worker runs as the one rank of torch.distributed.run")
    try:
        got = torch_launch().one_rank_group_check(
            "cuda", "nccl", ModelConfig(compute_dtype="bfloat16"),
            TRAIN_B // RANKS, NCCL_UPDATE_TOL, SEED)
        print("NCCL step check: " + json.dumps(got), flush=True)
        if multihost.comm_device().type != "cuda":
            fail("NCCL collectives do not run on the card")
        g, = multihost.all_sum([torch.arange(6.0, device="cuda")])
        if g.tolist() != [0.0, 1.0, 2.0, 3.0, 4.0, 5.0] or \
                multihost.allgather_bytes(b"x" * 300, chunk_bytes=128) != \
                [b"x" * 300] or multihost.broadcast_arrays(
                    {"a": np.arange(3)})["a"].tolist() != [0, 1, 2]:
            fail("NCCL collectives returned wrong values")
        print("NCCL collectives ok", flush=True)
        cli.main(argv)
    finally:
        dist.destroy()
    return 0


def phase9_launches(phase9: dict, name: str) -> dict:
    """A kernel's launches in phase 9's runs: the spill runs, each rank
    of the two-rank runs, and the NCCL run."""
    runs = {f"spill_{w}": st for w, st in phase9["spill"].items()}
    for plane, ranks in phase9["ranks"]["train"].items():
        runs.update({f"{plane}_rank{r}": st for r, st in enumerate(ranks)})
    runs.update({f"call_mods_rank{r}": st for r, st in
                 enumerate(phase9["ranks"]["call_mods"])})
    runs["nccl"] = phase9["nccl"]
    return {k: v["kernel_launches"][name] for k, v in runs.items()
            if v["kernel_launches"].get(name)}


def check_local_cards(torch, ab, cm, fused_lstm, ModelConfig, cli, tmp: str,
                      ckpt: str) -> dict:
    """Phase 10: call_mods over a process's local cards. The CLI's
    default --device resolved; the engine over two replicas on card 0
    against one replica (in turns: one, two, two, one; each run
    ``call_mods_ab.rate_run``: a warm-up, then a profiled run) on phase
    4e's dense TSV (defaults: float16 wire) and on phase 7's v3
    directory at int8: the same bytes, K1's bfloat16 kernel 5 times per
    forward tile (tiles counted per share), sites/s, wire bytes a site,
    each replica's forward device seconds. With two or more visible
    cards, the CLI over every card against --device cuda:0."""
    from deepsignal_plant_tpu_torch.utils.device import resolve_devices
    t_phase = time.time()
    every = [str(d) for d in resolve_devices(None)]
    log(f"phase 10: the CLI's default --device resolves to {every} "
        f"({torch.cuda.device_count()} visible card(s))")
    cfg = ModelConfig(dropout_rate=0.0, compute_dtype="bfloat16")
    card0 = torch.device("cuda", 0)
    out = {"cli_default_devices": every, "fixtures": {}}
    for name, inp, call in (
            ("dense_tsv", os.path.join(tmp, "dense.tsv"), cm.CallConfig()),
            ("v3_int8", os.path.join(tmp, "npz_v3"),
             cm.CallConfig(transfer_dtype="int8"))):
        engines = {k: cm.CallModsEngine(ckpt, cfg, call, [card0] * k)
                   for k in (1, 2)}
        runs = {1: [], 2: []}
        for k in (1, 2, 2, 1):
            path = os.path.join(tmp, f"cards_{name}_{k}.tsv")
            rate = ab.rate_run(engines[k], inp, path, fused_lstm.launches)
            rate["bytes"] = read_bytes(path)
            runs[k].append(rate)
        want = runs[1][0]["bytes"]
        res = {}
        for k, rs in runs.items():
            for rate in rs:
                st = rate["stats"]
                if rate.pop("bytes") != want:
                    fail(f"phase 10, {name}: {k} replica(s) wrote other "
                         f"rows than one replica")
                kl = rate["kernel_launches"]
                if kl[K1_BF16] != 5 * st["forward_tiles"] or \
                        sum(kl.values()) != kl[K1_BF16]:
                    fail(f"phase 10, {name}, {k} replica(s): launched {kl} "
                         f"for {st['forward_tiles']} forward tiles")
                if st["devices"] != ["cuda:0"] * k:
                    fail(f"phase 10, {name}: devices {st['devices']}")
            st = rs[-1]["stats"]
            res[k] = {
                "sites": st["sites"], "batches": st["batches"],
                "device_batch": st["device_batch"],
                "sites_per_s": [r["sites_per_s"] for r in rs],
                "wire_bytes_per_site": st["wire_bytes"] / st["sites"],
                "bases_per_site": st["bases_uploaded"] / st["sites"],
                "forward_tiles": st["forward_tiles"],
                "k1_bf16_launches": rs[-1]["kernel_launches"][
                    K1_BF16],
                "forward_device_seconds_per_card": [
                    r["stats"]["forward_device_seconds_per_card"]
                    for r in rs],
                "upload_device_seconds": [r["stats"]["upload_device_seconds"]
                                          for r in rs],
                "busy_share": [r["busy_share"] for r in rs],
                "wire_bytes_per_site_runs": [
                    r["stats"]["wire_bytes"] / r["stats"]["sites"]
                    for r in rs]}
        db, n, nb = res[2]["device_batch"], res[2]["sites"], res[2]["batches"]
        out["fixtures"][name] = res
        log(f"phase 10, {name} ({n} sites, {nb} batches of "
            f"{db}): two replicas on card 0 wrote one replica's bytes; "
            f"sites/s one {res[1]['sites_per_s']}, two "
            f"{res[2]['sites_per_s']}; wire bytes a site "
            f"{res[1]['wire_bytes_per_site']:.3f} -> "
            f"{res[2]['wire_bytes_per_site']:.3f}; K1 bf16 "
            f"{res[2]['k1_bf16_launches']} = 5 x {res[2]['forward_tiles']} "
            f"tiles (one replica 5 x {res[1]['forward_tiles']}); forward "
            f"device seconds per replica "
            f"{res[2]['forward_device_seconds_per_card']} against one "
            f"replica's {res[1]['forward_device_seconds_per_card']}")
    out["k1_bf16_kernels"] = k1_bf16_end_to_end(ab, cm, fused_lstm, cfg,
                                                card0, tmp, ckpt)
    if torch.cuda.device_count() >= 2:
        dense = os.path.join(tmp, "dense.tsv")
        cli_out = {}
        for label, extra in (("every", []), ("one", ["--device", "cuda:0"])):
            path = os.path.join(tmp, f"cards_cli_{label}.tsv")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["call_mods", "-i", dense, "-m", ckpt, "-o", path,
                          "--verbose_stages", *extra])
            st = json.loads(next(ln for ln in buf.getvalue().splitlines()
                                 if ln.startswith("[stages] "))[9:])
            cli_out[label] = {"devices": st["devices"],
                              "sites_per_s": st["sites_per_s"],
                              "bytes": read_bytes(path)}
        if cli_out["every"].pop("bytes") != cli_out["one"].pop("bytes") or \
                cli_out["every"]["devices"] != every:
            fail(f"phase 10: call_mods over every card: {cli_out}")
        out["cli"] = cli_out
        log(f"phase 10: the CLI over {every} wrote --device cuda:0's "
            f"bytes: {cli_out}")
    else:
        log("phase 10: one visible card, so the CLI over every card is "
            "the one-card run; two replicas on card 0 stand in for it")
    out["seconds"] = time.time() - t_phase
    log(f"phase 10 took {out['seconds']:.1f} s")
    return out


def k1_bf16_end_to_end(ab, cm, fused_lstm, cfg, card, tmp: str,
                       ckpt: str) -> dict:
    """Phase 10b: call_mods' engine on one card through each of K1's
    bfloat16 kernels in turns (wgmma, mma, mma, wgmma; each run
    ``call_mods_ab.rate_run``: a warm-up, then a profiled run) on phase
    4e's dense TSV, phase 7's v3 directory at int8, and the same at int8
    with --device_resident always (the resident compute window; the
    mma.sync kernel's runs inside ``fused_lstm.mma_only()``): sites/s,
    the forwards' device seconds and each run's launches (5 a tile of the
    kernel run, nothing else). The two kernels' rows are not compared
    byte for byte: their sums run in other orders."""
    res = {}
    for name, inp, call in (
            ("dense_tsv", os.path.join(tmp, "dense.tsv"), cm.CallConfig()),
            ("v3_int8", os.path.join(tmp, "npz_v3"),
             cm.CallConfig(transfer_dtype="int8")),
            ("v3_int8_resident", os.path.join(tmp, "npz_v3"),
             cm.CallConfig(transfer_dtype="int8",
                           device_resident="always"))):
        eng = cm.CallModsEngine(ckpt, cfg, call, card)
        runs = {"wgmma": [], "mma": []}
        for kernel in ("wgmma", "mma", "mma", "wgmma"):
            path = os.path.join(tmp, f"k1_{name}_{kernel}.tsv")
            with (fused_lstm.mma_only() if kernel == "mma" else
                  contextlib.nullcontext()):
                rate = ab.rate_run(eng, inp, path, fused_lstm.launches)
            st = rate["stats"]
            name_k = K1_BF16 if kernel == "wgmma" else K1_BF16_MMA
            want = {k: 0 for k in rate["kernel_launches"]}
            want[name_k] = 5 * st["forward_tiles"]
            if rate["kernel_launches"] != want:
                fail(f"phase 10b, {name} through the {kernel} kernel: "
                     f"launched {rate['kernel_launches']}")
            runs[kernel].append({
                "sites_per_s": rate["sites_per_s"],
                "forward_device_seconds": st["forward_device_seconds"],
                "seconds": st["seconds"], "busy_share": rate["busy_share"],
                "launches": want[name_k]})
        res[name] = runs
        log(f"phase 10b, {name} ({st['sites']} sites), in turns: "
            + "; ".join(f"{k}: sites/s {[round(r['sites_per_s']) for r in v]}"
                        f", forward device s "
                        f"{[r['forward_device_seconds'] for r in v]}"
                        for k, v in runs.items()))
    return res


def k1_f32_parts(timings, errs, checked, launched, narrow_extra) -> list:
    """The kernels line's entries of K1's float32 kernels (K1_F32_KERNELS),
    per 4096-row tile (the tail tile's beside): the projection kernel and
    K1's recurrence on each of its kernels (K1's wgmma recurrence and
    the float32 cluster kernel, timed in turns, rec_turns), over the
    layers whose route is the split route; the narrow and the in-loop kernels, over
    the narrow layers (seq and signal), whichever route they take (their
    times come from the turns of f32_turns). ``launched``: the float32
    call_mods run's counters; ``narrow_extra``: time_narrow_extra's
    rows."""
    rows = [r for r in timings if r["kernel"] == "k1_float32"]
    narrow_rows = [r for r in rows if "narrow_ms" in r]
    parts = []

    def entry(name, source, use, tail, ms, plain_ms, bound, library_ms,
              **extra):
        ops = sum(bound(r)[0] for r in use)
        nbytes = sum(bound(r)[1] for r in use)
        parts.append({
            "name": name, "route": "cuda",
            "source": "deepsignal_plant_tpu_torch/csrc/" + source,
            "replaces": "deepsignal_plant_tpu/ops/pallas_fused.py:62",
            "launches": launched[name], "max_abs_err": errs[name],
            "dtype": "float32", "layers": [r["layer"] for r in use],
            "ms": sum(r[ms] for r in use),
            "tail_layers": [r["layer"] for r in tail],
            "tail_ms": sum(r["tail_" + ms] for r in tail),
            "plain_ms": sum(r[plain_ms] for r in use),
            "bound_ms": max(ops, nbytes),
            "bound_by": "operations" if ops >= nbytes else "bytes",
            "library_ms": (sum(r[library_ms] for r in use)
                           if library_ms else None),
            "shapes_checked": [c for c in checked if c[4] == name],
            **extra})

    split = [r for r in rows if r["route"] == "split"]
    tail_split = [r for r in rows if r["tail_route"] == "split"]
    entry("fused_bilstm_proj_f32", "fused_bilstm.cu", split, tail_split,
          "proj_ms", "proj_plain_ms",
          lambda r: proj_bound(*r["F"], r["H"], TILE), "proj_library_ms")
    # library: torch.nn.LSTM at float32 on the same layers (cuDNN; it
    # computes the input projection too), as K2's entry takes it
    for name, kind in (("fused_bilstm_rec_f32_wgmma", "wgmma"),
                       ("fused_bilstm_rec_f32", "cluster")):
        entry(name, "lstm_recurrence.cu", split, tail_split,
              f"rec_{kind}_ms", "rec_plain_ms", lambda r: rec_bound(
                  "lstm_recurrence_fwd", r["H"], TILE, 4, PEAK_TF32_FLOPS,
                  TF32_PASSES), "library_ms",
              ms_runs=[r[f"rec_{kind}_ms_runs"] for r in split],
              taken_layers=[r["layer"] for r in split
                            if r["rec_plan"][0] == kind],
              tail_taken_layers=[r["layer"] for r in tail_split
                                 if r["tail_rec_plan"][0] == kind])
    parts[1]["plans"] = {r["layer"]: [r["rec_plan"], r["tail_rec_plan"]]
                         for r in rows}
    # the narrow layers' kernels: bound with products in 3xTF32, the FFMA
    # bound beside it; library torch.nn.LSTM at float32 on the same layers
    ffma = sum(max(r["ffma_ms"], r["bytes_ms"]) for r in narrow_rows)
    for name, route in (("fused_bilstm_f32_narrow", "narrow"),
                        ("fused_bilstm_f32_inloop", "inloop")):
        entry(name, "fused_bilstm.cu", narrow_rows, narrow_rows,
              route + "_ms", "plain_ms",
              lambda r: (r["ops_ms"], r["bytes_ms"]), "library_ms",
              device_ms=sum(r[route + "_ms"] for r in narrow_rows),
              taken_layers=[r["layer"] for r in narrow_rows
                            if r["route"] == route],
              tail_taken_layers=[r["layer"] for r in narrow_rows
                                 if r["tail_route"] == route],
              ffma_bound_ms=ffma)
    parts[3].update({
        "kernel_ms": sum(r["narrow_kernel_ms"] for r in narrow_rows),
        "plans": {r["layer"]: [r["narrow_plan"], r["tail_narrow_plan"]]
                  for r in narrow_rows},
        "routes_timed": [{k: r[k] for k in (
            "layer", "route", "replaced_route", "fastest", "narrow_faster",
            "narrow_ms", "inloop_ms", "split_ms")} for r in narrow_rows] + [
            {k: r["tail_" + k] for k in (
                "route", "replaced_route", "fastest", "narrow_faster",
                "narrow_ms", "inloop_ms", "split_ms")} | {
                "layer": r["layer"], "B": TAIL} for r in narrow_rows] + [
            {k: r[k] for k in (
                "F", "H", "B", "route", "replaced_route", "fastest",
                "narrow_faster", "narrow_ms", "inloop_ms", "split_ms",
                "plain_ms", "bound_ms", "ffma_bound_ms", "narrow_plan")}
            for r in narrow_extra]})
    return parts


def k1_f32_tile(timings, errs, checked, layers) -> dict:
    """K1 at float32 as a whole, a composite of its kernels' launches
    (not a kernel): sums over the five layers of one 4096-row tile (and
    of the tail tile) of the route each layer takes and of each route
    timed in turns (the narrow route over the layers it has a plan for);
    ``layers``: the float32 call_mods run's layer count."""
    rows = [r for r in timings if r["kernel"] == "k1_float32"]

    def total(key):
        return sum(r[key] for r in rows if key in r)

    def with_rec(kind, pre=""):
        """The tile's device time with the split layers' recurrence on
        kernel ``kind`` (their split route timed under force_k1_rec)."""
        return sum(r[f"{pre}split_{kind}_ms"] if r[pre + "route"] == "split"
                   and f"{pre}split_{kind}_ms" in r else r[pre + "device_ms"]
                   for r in rows)

    return {
        "device_ms_rec_wgmma": with_rec("wgmma"),
        "device_ms_rec_cluster": with_rec("cluster"),
        "tail_device_ms_rec_wgmma": with_rec("wgmma", "tail_"),
        "tail_device_ms_rec_cluster": with_rec("cluster", "tail_"),
        "what": "K1 float32 per tile, a composite of its kernels",
        "kernels": list(K1_F32_KERNELS), "layers_run": layers,
        "routes": [r["route"] for r in rows],
        "tail_routes": [r["tail_route"] for r in rows],
        "device_ms": total("device_ms"), "kernel_ms": total("kernel_ms"),
        "tail_device_ms": total("tail_device_ms"),
        "split_ms": total("split_ms"), "inloop_ms": total("inloop_ms"),
        "narrow_ms": total("narrow_ms"),
        "tail_split_ms": total("tail_split_ms"),
        "tail_inloop_ms": total("tail_inloop_ms"),
        "tail_narrow_ms": total("tail_narrow_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                     else "bytes"),
        "ffma_bound_ms": max(total("ffma_ms"), total("bytes_ms")),
        "library_ms": total("library_ms"),
        "max_abs_err": errs["k1_float32"],
        "shapes_checked": [c for c in checked if c[4] == "k1_float32"],
        "per_layer": rows}


# ---- phase 11: train and denoise over a process's local cards ---------------

def zero_launches(*counters) -> None:
    for counts in counters:
        for k in counts:
            counts[k] = 0


def check_local_train(torch, cli, train_mod, convert, FeatureDataset,
                      tmp: str, ranks: dict) -> dict:
    """Phase 11a: ``train_loop`` over two replicas on card 0, then over
    card 0 alone, one epoch of phase 4b's rows at the CLI's defaults
    (phase 9b's arguments), on the sharded-resident plane and on the
    host-fed plane. Each run's counts start at 0: 5 launches of K3, K4
    and dW_hh a step on each replica and 5 of K1's bfloat16 kernel per
    evaluation tile on each. The two replicas' parameters bitwise equal;
    on the sharded plane the two-replica weights within TRAIN_RANKS_TOL
    of phase 9b's two gloo ranks on the same rows and seed. (Launched
    ranks feed the host-fed plane in strided row shards, not in the
    replicas' global-batch layout; phase 11c holds that layout over two
    replicas against two ranks, through denoise.) ``ranks``: phase 9b's
    parameter files by plane."""
    from deepsignal_plant_tpu_torch.ops import fused_lstm, recurrence
    tr, va = os.path.join(tmp, "train.tsv"), os.path.join(tmp, "valid.tsv")
    train_ds, valid_ds = (FeatureDataset.from_file(p) for p in (tr, va))
    card0 = torch.device("cuda", 0)
    steps = -(-TRAIN_ROWS // TRAIN_B)
    out = {}
    for plane, resident in (("sharded", "auto"), ("host-fed", "never")):
        args = cli.build_parser().parse_args([
            "train", "--train_file", tr, "--valid_file", va, "--model_dir",
            tmp, "--max_epoch_num", "1", "--min_epoch_num", "1",
            "--step_interval", "100000", "--device_resident", resident])
        model_cfg, train_cfg = train_mod.train_configs(args, card0)
        want = None
        if plane == "sharded":
            with np.load(ranks[plane]) as z:
                want = {k[len("params/"):]: z[k] for k in z.files
                        if k.startswith("params/")}
        runs = {1: [], 2: []}
        for k in (2, 1):
            zero_launches(fused_lstm.launches, recurrence.launches)
            res = train_mod.train_loop(model_cfg, train_cfg, train_ds,
                                       valid_ds, None, [card0] * k,
                                       verbose=False)
            kl = train_mod.kernel_launches()
            name = plane if k > 1 or plane == "host-fed" else "resident"
            if (res["plane"], res["steps"], res["train_rows"],
                    res["local_batch"]) != (name, steps, TRAIN_ROWS,
                                            TRAIN_B // k):
                fail(f"phase 11, {plane} at {k} replica(s): {res['plane']}, "
                     f"{res['steps']} steps, {res['train_rows']} rows, "
                     f"{res['local_batch']} a replica")
            check_launches(f"phase 11, {plane} at {k} replica(s)", kl, {
                "lstm_recurrence_fwd_save": 5 * steps * k,
                "lstm_recurrence_bwd": 5 * steps * k,
                "lstm_dw_hh": 5 * steps * k,
                K1_BF16: 5 * res["eval_tiles"] * k})
            got = convert._flatten(res["params"])
            run = {"samples_per_s": res["train_rows"] / res["train_seconds"],
                   "train_seconds": res["train_seconds"],
                   "eval_seconds": res["eval_seconds"],
                   "eval_tiles": res["eval_tiles"],
                   "valid_accuracies": res["valid_accuracies"],
                   "kernel_launches": kl,
                   "k3_k4_dw_hh_per_replica_step": [
                       kl[n] / (k * steps) for n in (
                           "lstm_recurrence_fwd_save", "lstm_recurrence_bwd",
                           "lstm_dw_hh")]}
            if k > 1:
                other = convert._flatten(res["replica_params"][0])
                if any(not np.array_equal(got[n], other[n]) for n in got):
                    fail(f"phase 11, {plane}: the two replicas' parameters "
                         f"differ")
            if k > 1 and want is not None:
                if sorted(got) != sorted(want):
                    fail(f"phase 11, {plane}: parameter names differ from "
                         f"the ranks'")
                run["max_abs_diff_vs_ranks"] = max(
                    float(np.abs(got[n] - want[n]).max()) for n in got)
                if run["max_abs_diff_vs_ranks"] > TRAIN_RANKS_TOL:
                    fail(f"phase 11, {plane}: two replicas end "
                         f"{run['max_abs_diff_vs_ranks']} from two gloo "
                         f"ranks (tolerance {TRAIN_RANKS_TOL})")
            runs[k].append(run)
        out[plane] = runs
        vs_ranks = ("; max |two replicas - two gloo ranks| "
                    f"{runs[2][0]['max_abs_diff_vs_ranks']} (phase 9b)"
                    if want is not None else "")
        log(f"phase 11, train over [cuda:0, cuda:0], then [cuda:0], "
            f"{plane} plane, one epoch of {TRAIN_ROWS} rows ({steps} steps "
            f"of {TRAIN_B}): samples/s two replicas "
            f"{runs[2][0]['samples_per_s']:.1f}, one "
            f"{runs[1][0]['samples_per_s']:.1f}; K3/K4/dW_hh a replica a "
            f"step {runs[2][0]['k3_k4_dw_hh_per_replica_step']}; replicas "
            f"bitwise equal{vs_ranks}")
    return out


def time_replica_steps(torch, train_mod, ModelConfig, FeatureDataset,
                       init_params) -> dict:
    """Phase 11b: one ``train_step`` of a 512-row global batch at the
    train CLI's defaults (bfloat16, dropout 0.5, Adam) over one replica
    and over two on card 0 (256 rows each, masked as the padded planes
    mask), in turns (one, two, two, one), 10 steps each after 3: the
    host's time to enqueue it and its device time (CUDA events, the
    enqueue included), medians."""
    cfg = ModelConfig(compute_dtype="bfloat16")
    card0 = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    n = 32 * TRAIN_B
    ds = FeatureDataset(
        rng.integers(0, 4, (n, T)).astype(np.int32),
        rng.normal(size=(n, T)).astype(np.float32),
        np.abs(rng.normal(size=(n, T))).astype(np.float32),
        rng.integers(1, 30, (n, T)).astype(np.float32),
        rng.normal(size=(n, T, 16)).astype(np.float32),
        rng.integers(0, 2, n).astype(np.int32))
    src = train_mod.Resident(ds, card0)
    order = torch.from_numpy(rng.permutation(n)).to(card0)
    params = init_params(cfg, SEED)
    sched = train_mod.step_decay_schedule(1e-3, 32, 2, 0.1)
    reps = {k: [train_mod.Replica(params, cfg, card0, "Adam", sched, 1.0)
                for _ in range(k)] for k in (1, 2)}
    times = {1: ([], []), 2: ([], [])}

    def step(k, i):
        b = TRAIN_B // k
        parts = []
        for j in range(k):
            lo = (i % 32) * TRAIN_B + j * b
            batch, labels = src.batch(order[lo:lo + b])
            mask = None if k == 1 else torch.ones(b, device=card0)
            parts.append((batch, labels, mask))
        gens = [train_mod.step_generator(SEED + 1, i, card0,
                                         j if k > 1 else None)
                for j in range(k)]
        return train_mod.train_step(reps[k], parts, 0.5, gens)

    i = 0
    for k in (1, 2, 2, 1):
        for _ in range(3):
            step(k, i)
            i += 1
        torch.cuda.synchronize()
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            step(k, i)
            times[k][1].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            times[k][0].append(start.elapsed_time(end))
            i += 1
    out = {str(k): {"device_ms": statistics.median(times[k][0]),
                    "host_enqueue_ms": statistics.median(times[k][1]),
                    "rows_a_replica": TRAIN_B // k} for k in (1, 2)}
    log(f"phase 11, one {TRAIN_B}-row step (bf16, dropout 0.5, Adam): one "
        f"replica {out['1']['host_enqueue_ms']:.2f} ms to enqueue, "
        f"{out['1']['device_ms']:.2f} ms on the card; two replicas on card 0 "
        f"{out['2']['host_enqueue_ms']:.2f} / {out['2']['device_ms']:.2f} ms")
    return out


def check_local_denoise(cli, denoise_mod, torch, tmp: str,
                        phase8b: dict) -> dict:
    """Phase 11c: ``denoise`` over two replicas on card 0 in this
    process (its resolve_devices answering [cuda:0, cuda:0]) on each of
    phase 8b's planes with 8b's file and arguments: the final file byte
    for byte 8b's two-rank file, each replica's launches against the
    steps and forward tiles."""
    from deepsignal_plant_tpu_torch.ops import fused_lstm, recurrence
    card0 = torch.device("cuda", 0)
    out = {}
    for name in ("global", "sharded"):
        inp = phase8b[name]["input"]
        d = os.path.join(tmp, f"local_denoise_{name}")
        os.makedirs(d)
        src = os.path.join(d, "noisy.tsv")
        shutil.copy(inp["train_file"], src)
        zero_launches(fused_lstm.launches, recurrence.launches)
        buf = io.StringIO()
        real = denoise_mod.resolve_devices
        os.environ["DSP_DENOISE_RESIDENT_MIN_ROWS"] = inp["min_rows"]
        denoise_mod.resolve_devices = lambda choice: [card0, card0]
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(["denoise", "--train_file", src, "--fst_iter_prob",
                          *inp["args"], "--verbose_stages"])
        finally:
            denoise_mod.resolve_devices = real
            del os.environ["DSP_DENOISE_RESIDENT_MIN_ROWS"]
        st = json.loads(next(ln for ln in buf.getvalue().splitlines()
                             if ln.startswith("[stages] "))[9:])
        kl = {**fused_lstm.launches, **recurrence.launches}
        if (st["devices"], st["world_size"], st["local_batch"],
                st["sharded_trainings"]) != (
                ["cuda:0", "cuda:0"], 1, TRAIN_B // 2,
                st["mini_trainings"] if name == "sharded" else 0):
            fail(f"phase 11, denoise ({name}): {st}")
        layers, steps = DENOISE_LAYERS, st["steps"]
        if "float32" in inp["args"]:
            want = {"lstm_recurrence_fwd_save_f32": layers * steps * 2,
                    "lstm_recurrence_bwd_f32": layers * steps * 2,
                    "lstm_dw_hh": layers * steps * 2}
            k1 = k1_f32_layers(kl)
            if {k: kl[k] for k in want} != want or \
                    k1 != layers * st["forward_tiles"]:
                fail(f"phase 11, denoise ({name}) launched {kl} for {steps} "
                     f"steps and {st['forward_tiles']} forward tiles")
        else:
            check_launches(f"phase 11, denoise ({name})", kl, {
                "lstm_recurrence_fwd_save": layers * steps * 2,
                "lstm_recurrence_bwd": layers * steps * 2,
                "lstm_dw_hh": layers * steps * 2,
                K1_BF16: layers * st["forward_tiles"]})
        same = file_digest(st["final_file"]) == phase8b[name]["final_sha256"]
        ranks_s = max(r["seconds"] for r in phase8b[name]["ranks"])
        out[name] = {k: st[k] for k in (
            "steps", "forward_tiles", "accuracy_checks", "score_tiles",
            "mini_trainings", "seconds", "train_seconds", "score_seconds",
            "mini_trainings_per_s", "samples_per_s")}
        out[name].update({"kernel_launches": kl, "same_file": same,
                          "ranks_seconds": ranks_s})
        log(f"phase 11, denoise over [cuda:0, cuda:0] ({name} plane, 8b's "
            f"arguments): {st['seconds']:.2f} s ({steps} steps, "
            f"{st['forward_tiles']} forward tiles) against 8b's two ranks' "
            f"{ranks_s:.2f} s; final file "
            f"{'equal to' if same else 'DIFFERS from'} 8b's, byte for byte")
        if not same:
            fail(f"phase 11: denoise over two replicas ({name}) wrote other "
                 f"bytes than two ranks")
    return out


def check_allocator_ab(ab, tmp: str, ckpt: str) -> dict:
    """Phase 11d: ``call_mods_ab.py`` with the host-allocator tune, then
    without it (glibc's own thresholds), a fresh process each, each on
    phase 4e's dense TSV and on phase 4's sparse TSV four times over:
    the rows byte for byte the same in every run, 5 launches of K1's
    bfloat16 kernel per forward tile, sites/s, the parse stages and the
    card's busy share of each, with phase 4's checkpoint. (The README's
    call_mods_ab.py command runs the arms in turns, four processes, for
    a reading.)"""
    sparse = os.path.join(tmp, "ab_sparse.tsv")
    with open(sparse, "wb") as wf:
        for _ in range(4):
            with open(os.path.join(tmp, "features.tsv"), "rb") as rf:
                shutil.copyfileobj(rf, wf)
    arms = ("tuned", "default")
    inputs = [("dense", os.path.join(tmp, "dense.tsv")), ("sparse", sparse)]
    runs = []
    for arm in arms:
        try:
            runs += ab.run_child(REPO, inputs, ckpt, tmp, ["default"], arm)
        except RuntimeError as exc:
            fail(f"call_mods_ab.py, the {arm} arm: {exc}")
    if len(runs) != len(inputs) * len(arms):
        fail(f"call_mods_ab.py gave {len(runs)} runs")
    out = {}
    for fixture in ("dense", "sparse"):
        rs = [r for r in runs if r["fixture"] == fixture]
        if len({r["rows_sha256"] for r in rs}) != 1:
            fail(f"phase 11, allocator A/B ({fixture}): the rows differ")
        for r in rs:
            kl, st = r["kernel_launches"], r["stats"]
            if kl[K1_BF16] != 5 * st["forward_tiles"] or \
                    sum(kl.values()) != kl[K1_BF16]:
                fail(f"phase 11, allocator A/B ({fixture}): launched {kl}")
            if r["allocator_tuned"] != (r["allocator"] == "tuned"):
                fail(f"phase 11, allocator A/B: the {r['allocator']} arm ran "
                     f"with the tune {r['allocator_tuned']}")
        out[fixture] = {arm: [{"sites_per_s": r["sites_per_s"],
                               "busy_share": r["busy_share"],
                               **{k: r["stats"][k] for k in (
                                   "sites", "parse_seconds",
                                   "parse_wait_seconds", "batch_seconds",
                                   "seconds")}}
                              for r in rs if r["allocator"] == arm]
                        for arm in ("tuned", "default")}
        log(f"phase 11, allocator A/B on the {fixture} TSV "
            f"({rs[0]['stats']['sites']} sites; tuned, then default, a "
            f"process each, profiled): sites/s "
            f"{[round(r['sites_per_s'], 1) for r in rs]}, parse_wait_seconds "
            f"{[round(r['stats']['parse_wait_seconds'], 4) for r in rs]}, "
            f"busy share {[round(r['busy_share'], 4) for r in rs]}; rows "
            f"byte-identical")
    return out


def phase11_launches(phase11: dict, name: str) -> dict:
    """A kernel's launches in phase 11's runs: each train run (plane,
    replicas, turn) and each local denoise."""
    runs = {f"train_{plane}_{k}_replicas_{i}": r
            for plane, by_k in phase11["train"].items()
            for k, rs in by_k.items() for i, r in enumerate(rs)}
    runs.update({f"denoise_{p}": st for p, st in phase11["denoise"].items()})
    return {k: v["kernel_launches"][name] for k, v in runs.items()
            if v["kernel_launches"].get(name)}


def log_narrow_ptxas(_build) -> None:
    """ptxas's registers, stack and spills of each instance of the narrow
    kernel (MT m16 tiles, U units a block, C blocks a cluster, KX x
    columns), from csrc/fused_bilstm.cu's build log."""
    text = _build.library_path("fused_bilstm").with_suffix(
        ".so.log").read_text()
    for entry in text.split("Compiling entry function")[1:]:
        m = re.search(r"narrow_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                      entry)
        if m:
            info = " ".join(ln.split(":", 1)[-1].strip()
                            for ln in entry.splitlines()[1:]
                            if "Used" in ln or "spill" in ln)
            log("ptxas, narrow kernel MT={} U={} C={} KX={}: {}".format(
                *m.groups(), info))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one card")
    sys.path.insert(0, REPO)
    try:
        from deepsignal_plant_tpu_torch import cli, native
        from deepsignal_plant_tpu_torch.config import ModelConfig
        from deepsignal_plant_tpu_torch.io.dataset import FeatureDataset
        from deepsignal_plant_tpu_torch.models import bilstm
        from deepsignal_plant_tpu_torch.models.bilstm import (
            Batch, ModelBiLSTM, forward_flops_per_site, init_params)
        from deepsignal_plant_tpu_torch.models import convert
        from deepsignal_plant_tpu_torch.models.convert import (
            load_checkpoint, save_checkpoint)
        from deepsignal_plant_tpu_torch.ops import _build, fused_lstm
        from deepsignal_plant_tpu_torch.ops import lstm as plain
        from deepsignal_plant_tpu_torch.ops import recurrence
        from deepsignal_plant_tpu_torch.pipeline import call_mods
        from deepsignal_plant_tpu_torch.pipeline import denoise as denoise_mod
        from deepsignal_plant_tpu_torch.pipeline import train as train_mod
        import call_mods_ab as ab
    except ImportError as exc:
        fail(f"the deepsignal_plant_tpu_torch package is not beside this "
             f"script ({exc})")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 is full f32
    torch.backends.cudnn.allow_tf32 = False         # and so is cuDNN's LSTM

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}), device 0 = {kind}")

    # phase 2: build (one nvcc per source and g++ for the host parser,
    # all at once) and check
    t0 = time.time()
    sources = ("fused_bilstm", "lstm_recurrence")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        builds = [pool.submit(_build.build, name) for name in sources]
        parser = pool.submit(native.load)
    for name, build in zip(sources, builds):
        build.result()       # a build that failed raises here, with its log
        _build.load(name)
        log(f"built csrc/{name}.cu ({time.time() - t0:.1f} s for all): "
            + _build.library_path(name).with_suffix(".so.log").read_text()
            .strip().replace("\n", " | ")[-600:])
    parser.result()
    log_narrow_ptxas(_build)
    log(f"built native/featparse.cpp with {native.CXX} "
        f"{' '.join(native.CXX_FLAGS)}: {native.library_path().name}")
    errs, checked = check_kernel(torch, fused_lstm, recurrence, plain)
    plans = rec_plans(torch, recurrence)
    rec_errs, rec_checked = check_recurrence(torch, recurrence, plain)

    # phase 3: timing
    timings = time_kernel(torch, fused_lstm, recurrence, plain)
    k1_ab = time_k1_bf16_ab(os.path.join(REPO, "build", "parent"))
    narrow_extra = time_narrow_extra(torch, fused_lstm, plain)
    forward = time_forward(torch, ModelConfig, ModelBiLSTM, Batch,
                           init_params)
    rec_timings = time_recurrence(torch, recurrence, plain)
    step_timing = {dt: time_train_step(torch, ModelConfig, FeatureDataset,
                                       init_params, train_mod, dt)
                   for dt in ("bfloat16", "float32")}

    # phase 4: the main paths; their counts start at 0 in fresh processes
    for counts in (fused_lstm.launches, recurrence.launches):
        for k in counts:
            counts[k] = 0
    with tempfile.TemporaryDirectory() as tmp:
        run = check_main_path(tmp, ab, ModelConfig, init_params,
                              save_checkpoint,
                              f32_call_mods_launches(torch, fused_lstm,
                                                     recurrence))
        trained = check_training(tmp, ab)
        if any(fused_lstm.launches.values()) or any(
                recurrence.launches.values()):
            fail("phases 4 and 4b launched kernels in this process")
        run["rate"] = check_rate_run(torch, ab, call_mods, fused_lstm,
                                     ModelConfig, tmp, run["ckpt"])
        f32_train = check_f32_training(tmp, ab, recurrence, train_mod.train,
                                       cli.build_parser(), init_params,
                                       ModelConfig)
        k2_path = check_k2_path(torch, bilstm, recurrence, Batch,
                                FeatureDataset, load_checkpoint,
                                trained["best_ckpt"], trained["valid_tsv"])
        # phase 5: serve in a fresh process, call_freq in this one
        serve = check_serve(tmp, run["ckpt"], run, ab)
        freq = check_call_freq(torch, cli, tmp, serve["outputs"])
        # phase 6: extract, call_mods and serve on fast5 runs; phase 7:
        # the .npz planes on 256 of its reads
        fast5_run = check_fast5(tmp, run["ckpt"])
        npz_run = fast5_run.pop("npz")
        # phase 8: denoise, train --resume and --stream
        phase8 = check_denoise_resume_stream(tmp, ab)
        # phase 8b: denoise at two ranks, one NCCL rank; ResNet3
        phase8b = check_denoise_ranks(tmp)
        phase8b["resnet3"] = check_resnet(torch, cuda_ms)
        # phase 9: the spill plane; two ranks on card 0 over gloo; one
        # rank under torch.distributed.run (NCCL)
        t9 = time.time()
        phase9 = {"spill": check_spill(tmp, trained),
                  "ranks": check_ranks(tmp, trained, run["ckpt"]),
                  "nccl": check_nccl(tmp)}
        phase9["seconds"] = time.time() - t9
        log(f"phase 9 took {phase9['seconds']:.1f} s")
        # phase 10: call_mods over a process's local cards
        phase10 = check_local_cards(torch, ab, call_mods, fused_lstm,
                                    ModelConfig, cli, tmp, run["ckpt"])
        # phase 11: train and denoise over a process's local cards (two
        # replicas on card 0); the host-allocator A/B
        t11 = time.time()
        phase11 = {
            "train": check_local_train(torch, cli, train_mod, convert,
                                       FeatureDataset, tmp,
                                       phase9["ranks"]["params"]),
            "step": time_replica_steps(torch, train_mod, ModelConfig,
                                       FeatureDataset, init_params),
            "denoise": check_local_denoise(cli, denoise_mod, torch, tmp,
                                           phase8b),
            "allocator": check_allocator_ab(ab, tmp, run["ckpt"])}
        phase11["seconds"] = time.time() - t11
        log(f"phase 11 took {phase11['seconds']:.1f} s")
    flops = forward_flops_per_site(ModelConfig())
    for what, st in (("sparse fixture", run["stages"]),
                     ("dense rate run", {**run["rate"]["stats"],
                                         "sites_per_s":
                                         run["rate"]["sites_per_s"]})):
        log(f"call_mods, {what}: {st['sites_per_s']:.1f} sites/s on {smi} "
            f"({st['sites']} sites in {st['seconds']:.3f} s; model "
            f"{flops / 1e9:.3f} GFLOP/site -> "
            f"{st['sites_per_s'] * flops / 1e12:.3f} TFLOP/s); stages "
            + json.dumps({k: st[k] for k in STAGE_FIELDS}))

    kernels = {"kernels": []}
    rows = [r for r in timings if r["kernel"] == K1_BF16]

    def total(key):
        return sum(r[key] for r in rows)

    # the two bf16 kernels compute the same layers: one plain, bound and
    # library figure serves both; times are sums over the five launches
    # of one 4096-row tile (tail_: the TAIL-row tile), ms device time
    # (graph replays, the two kernels in turns), kernel_ms events per
    # call; launches from the default call_mods run (phase 4, a fresh
    # process) and the other phases' runs
    same = {"source": "deepsignal_plant_tpu_torch/csrc/fused_bilstm.cu",
            "replaces": "deepsignal_plant_tpu/ops/pallas_fused.py:62",
            "route": "cuda", "dtype": "bfloat16",
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                         else "bytes"),
            "library_ms": total("library_ms")}
    # launches: the main path's run (phase 4; the mma.sync kernel takes
    # none of its layers); phase 10b's runs through each kernel apart
    for name, pre in ((K1_BF16, ""), (K1_BF16_MMA, "mma_")):
        kernels["kernels"].append({
            "name": name, **same,
            "launches": run["launches_by_kernel"][name],
            "max_abs_err": errs[name],
            "ms": total(pre + "device_ms"),
            "device_ms": total(pre + "device_ms"),
            "kernel_ms": total(pre + "kernel_ms"),
            "tail_device_ms": total("tail_" + pre + "device_ms"),
            "tail_kernel_ms": total("tail_" + pre + "kernel_ms"),
            "shapes_checked": [c for c in checked if c[4] == name],
            "phase6c_launches": fast5_run["vbz"]["call_mods"]["vbz"][
                "kernel_launches"][name],
            "phase6d_launches": fast5_run["features"]["call_mods"][
                "kernel_launches"][name],
            "phase8_launches": phase8_launches(phase8, name),
            "phase8b_launches": phase8b_launches(phase8b, name),
            "phase9_launches": phase9_launches(phase9, name),
            "phase11_launches": phase11_launches(phase11, name),
            "phase10b_launches": {
                fx: [r["launches"] for r in runs["wgmma" if name == K1_BF16
                                                 else "mma"]]
                for fx, runs in phase10["k1_bf16_kernels"].items()},
            **({"phase10_launches": {
                f"{fx}_{k}_replicas": res[k]["k1_bf16_launches"]
                for fx, res in phase10["fixtures"].items() for k in (1, 2)},
                "per_launch": rows, "model_forward": forward,
                "parent_in_turns": {who: {k: v for k, v in o.items()
                                          if k != "runs"}
                                    for who, o in k1_ab.items()},
                "main_path": run} if name == K1_BF16 else {})})
    # K1's float32 kernels, launches from the float32 call_mods run; the
    # whole float32 layer route per tile rides on the projection's entry
    f32_parts = k1_f32_parts(timings, errs, checked,
                             run["f32_launches_by_kernel"], narrow_extra)
    f32_parts[0]["k1_float32_tile"] = k1_f32_tile(timings, errs, checked,
                                                  run["f32_layers"])
    for part in f32_parts:
        part["phase8_launches"] = phase8_launches(phase8, part["name"])
        part["phase8b_launches"] = phase8b_launches(phase8b, part["name"])
        part["phase11_launches"] = phase11_launches(phase11, part["name"])
    kernels["kernels"] += f32_parts
    # the recurrence kernels: times per train step at batch 512 in bf16
    # (two H=128 and three H=256 launches); launches from the train run
    # (4b), and for K2 from the fused-off 512-row inference tile (4d);
    # K2, K3 and K4's recurrence run the cluster kernels of `plans`
    for name, replaces in REC_KERNELS.items():
        t = rec_timings[name]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "deepsignal_plant_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": replaces, "dtype": "bfloat16",
            "launches": (k2_path[f"bfloat16 {TRAIN_B}"]["launches_by_kernel"]
                         [name] if name == "lstm_recurrence_fwd"
                         else trained["launches"][name]),
            **({"plans": {k: v for k, v in plans.items()
                          if k.startswith(name + " bfloat16 ")}}
               if name != "lstm_dw_hh" else {}),
            "max_abs_err": (max(rec_errs[name].values())
                            if name == "lstm_dw_hh"
                            else rec_errs[name]["bfloat16"]),
            "phase8_launches": phase8_launches(phase8, name),
            "phase8b_launches": phase8b_launches(phase8b, name),
            "phase9_launches": phase9_launches(phase9, name),
            "phase11_launches": phase11_launches(phase11, name),
            **t, "shapes_checked": rec_checked})
    kernels["kernels"][-1]["float32"]["launches_f32_training"] = (
        f32_train["launches"]["lstm_dw_hh"])
    # the float32 cluster kernels: times per 512-row step; launches from
    # float32 training (4c: K3, K4) and the fused-off 512-row float32 tile
    # (4d: K2)
    for name, wrapper in F32_KERNELS.items():
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "deepsignal_plant_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": REC_KERNELS[wrapper], "dtype": "float32",
            "launches": (k2_path[f"float32 {TRAIN_B}"]["launches_by_kernel"]
                         [name] if wrapper == "lstm_recurrence_fwd"
                         else f32_train["launches"][name]),
            "plans": {k: v for k, v in plans.items()
                      if k.startswith(wrapper + " float32 ")},
            "max_abs_err": rec_errs[wrapper]["float32"],
            "phase8_launches": phase8_launches(phase8, name),
            "phase8b_launches": phase8b_launches(phase8b, name),
            "phase11_launches": phase11_launches(phase11, name),
            **rec_timings[name], "shapes_checked": rec_checked})
    log("train summary: " + json.dumps({
        **trained, "f32_kernel_vs_plain": f32_train, "k2_path": k2_path,
        "step": step_timing}))
    log("host paths summary on " + smi + ": " + json.dumps(
        {"serve": {k: v for k, v in serve.items() if k != "outputs"},
         "call_freq": freq}))
    log("fast5 summary on " + smi + ": " + json.dumps(fast5_run))
    log(".npz planes summary on " + smi + ": " + json.dumps(npz_run))
    log("denoise, resume and stream summary on " + smi + ": "
        + json.dumps(phase8))
    log("denoise at two ranks and ResNet3 summary on " + smi + ": "
        + json.dumps(phase8b))
    log("spill, ranks and NCCL summary on " + smi + ": "
        + json.dumps(phase9))
    log("local cards summary on " + smi + ": " + json.dumps(phase10))
    log("train and denoise over local cards, allocator A/B summary on "
        + smi + ": " + json.dumps(phase11))
    log(f"train: {trained['samples_per_s_last_epoch']:.1f} samples/s in "
        f"the last epoch ({trained['ms_per_step_last_epoch']:.2f} ms per "
        f"{TRAIN_B}-row step with its evaluations excluded) on {smi}")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--nccl-worker"]:
        sys.exit(nccl_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--k1-bf16-times"]:
        print(json.dumps(k1_bf16_layer_times(sys.argv[2])))
        sys.exit(0)
    sys.exit(main())
