#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepsignal_plant_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, runs and
agrees with itself on the card.

    python3 chip_smoke.py          # from the repository root; one card

Phases, in order; any failure exits non-zero before the last line:

1. the card: name and power limit (nvidia-smi), torch's device name;
2. every kernel of the main paths, built from csrc/ by nvcc (one nvcc
   per source, all started together), against its plain PyTorch version
   on the card at the main paths' shapes: the fused BiLSTM layer (K1) at
   call_mods' 4096-row tiles, its ragged neighbour and the 1,016-row
   tail, and at phase 8 denoise's signal_bilstm layers in 512-row tiles
   and ragged tails, in bfloat16 (the main path's kernel) and in float32 (for
   exact-parity runs) through the route each layer takes and through
   both routes called directly (the 3xTF32 projection kernel and the
   float32 recurrence; the in-loop kernel), the two routes against each
   other, and the projection kernel alone; (2b) the
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
   (float32: its two routes in turns at every layer, three pairs each,
   and the projection kernel and K1's recurrence on their own), (3b) the
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
   = the CLI's, a .done marker);
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
8. denoise, resume and the streaming dataset, each a fresh CLI process:
   ``denoise`` with its defaults (bf16, signal_bilstm at hidden 256,
   dropout 0.5; ``--iterations 2 --rounds 1 --epoch_num 2``, an accuracy
   check every 4 steps) on a seeded learnable 16,384-row TSV with 20% of
   its label-0 rows flipped to 1: 4 launches of K3, K4 and dW_hh per step
   and of K1's bfloat16 kernel per forward tile (accuracy checks and
   scoring), label-1 purity against the true labels rising, wall time
   and mini-trainings/s; the same denoise in float32 at dropout 0
   through the kernels and through the plain versions (the same final
   file, the first iteration's mean scores within 1e-3); ``train`` for
   one epoch on phase 4b's rows, then ``--resume`` to two (it starts at
   epoch 2 and step 32), and one epoch with ``--stream yes``: 5 launches
   of K3, K4 and dW_hh per step, samples/s of each plane;
9. a ``{"kernels": [...]}`` line (phase 8's launches beside each
   kernel's main-path count), the card line, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package. Without a card, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gzip
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
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
# K1 in each compute dtype: bfloat16 its kernel (ops/fused_lstm.py's
# counter); float32 the layer through the route it takes ("k1_float32" is
# a route of two or one launches, not a kernel: the kernels line lists
# its kernels, K1_F32_KERNELS)
K1_KERNELS = {"fused_bilstm_bf16": "bfloat16", "k1_float32": "float32"}
# K1's routes (float32: "split", the projection kernel and the recurrence;
# "inloop", the in-loop kernel) -> the key their errors go under
K1_ROUTE_KEYS = {"bf16": "fused_bilstm_bf16", "split": "fused_bilstm_rec_f32",
                 "inloop": "fused_bilstm_f32_inloop"}
K1_F32_KERNELS = ("fused_bilstm_proj_f32", "fused_bilstm_rec_f32",
                  "fused_bilstm_f32_inloop")
K1_ERR_KEYS = ("fused_bilstm_bf16", "k1_float32") + K1_F32_KERNELS
# K1's float32 routes timed in turns (split, in-loop, in-loop, split) this
# many times per layer and batch, to show their spread
K1_F32_PAIRS = 3
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
DENOISE_TILES = (512, 509, 93)
DENOISE_ARGS = ("--iterations", "2", "--rounds", "1", "--epoch_num", "2",
                "--step_interval", str(DENOISE_CHECK), "--seed", "77")
# float32 denoise, kernels against the plain versions at dropout 0: the
# first iteration's mean scores (2 x 16 steps of training apart, each
# step's float32 sums in other orders) and the rows kept
DENOISE_SCORE_TOL = 1e-3
# the [stages] fields of call_mods that say where its time goes
STAGE_FIELDS = ("batches", "packed_batches", "packed_sites",
                "persite_batches", "persite_sites", "bases_uploaded",
                "wire_bytes", "parse_seconds",
                "parse_wait_seconds", "batch_seconds", "device_seconds",
                "format_seconds", "upload_device_seconds",
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
    either the in-loop kernel or the projection kernel and the recurrence
    kernel of the plan (cluster or streaming)."""
    want = {k: 0 for k in fused_lstm.launches}
    if route == "bf16":
        want["fused_bilstm_bf16"] = 1
        return want
    if route == "inloop":
        want["fused_bilstm_f32_inloop"] = 1
    else:
        want["fused_bilstm_proj_f32"] = 1
        want["fused_bilstm_rec_f32" if plan else
             "fused_bilstm_rec_f32_stream"] = 1
    return want


def k1_plan(torch, recurrence, B, H):
    """K1's recurrence plan on card 0: K2's float32 recurrence_plan."""
    return recurrence.recurrence_plan(0, B, H, lambda C, r: (
        recurrence.cluster_capacity(0, 0, H, C, r, torch.float32)),
        torch.float32)


def f32_routes(fused_lstm):
    """K1's float32 routes, called directly."""
    return {"split": fused_lstm.layer_f32_split,
            "inloop": fused_lstm.layer_f32_inloop}


def f32_route(torch, fused_lstm, F, H, B):
    """The float32 route bilstm_layer_fused takes on card 0."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return "inloop" if fused_lstm.f32_inloop(F, H, B, sms) else "split"


def check_kernel(torch, fused_lstm, recurrence, plain):
    """Phase 2: K1 against the plain version at every layer shape of the
    main path (full, ragged and tail 4096-row tiles) and of phase 8's
    denoise (signal_bilstm's layers in 512-row tiles and their tails),
    seq_out True and False: the bfloat16 kernel, and float32 through the
    route it takes and through both of its routes called directly (the
    projection kernel and the recurrence; the in-loop kernel), which are
    also held against each other; the float32 projection kernel alone
    against its plain version. Each launch must move the counters of the
    kernels named."""
    cases = [(shape, (TILE, TILE - 3, TAIL)) for shape in sorted(
        {(Fa, Fb, H) for Fa, Fb, H, _ in MAIN_PATH_LAYERS.values()})]
    cases += [(shape, DENOISE_TILES) for shape in DENOISE_K1_SHAPES]
    errs = {k: 0.0 for k in K1_ERR_KEYS}
    checked = []
    for (Fa, Fb, H), tiles in cases:
        for B in tiles:
            for dname in ("bfloat16", "float32"):
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
                routes = (("bf16", None),) if dtype == torch.bfloat16 else (
                    (auto, None), ("split", "split"), ("inloop", "inloop"))
                for seq_out in (True, False):
                    want = plain.bilstm_layer(xs, w_ih, b, w_hh, H, seq_out)
                    outs = {}
                    for route, force in routes:
                        before = dict(fused_lstm.launches)
                        layer = (f32_routes(fused_lstm)[force] if force
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
                        key = K1_ROUTE_KEYS[route]
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
                        err = max((a - c).abs().max().item() for a, c in zip(
                            outs["split"], outs["inloop"]))
                        log(f"float32 K1 routes against each other F=({Fa},"
                            f"{Fb}) H={H} B={B} seq_out={seq_out}: "
                            f"max|split - inloop| = {err:.3g}")
                        if err > TOL[dname]:
                            fail(f"K1's float32 routes disagree by {err}")
    return errs, checked


def proj_bound(Fa, Fb, H, B):
    """(ms at the peak operation rate, ms at the memory rate) of the
    float32 projection kernel's work: its f32 products in 3xTF32, and x,
    W_ih and the bias read once, xproj (T, 2, B, 4H) written once."""
    F = Fa + Fb
    flops = 2 * 2 * T * B * F * 4 * H * TF32_PASSES
    nbytes = 4 * (T * B * F + 2 * F * 4 * H + 2 * 4 * H + T * 2 * B * 4 * H)
    return flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def time_k1_f32(torch, fused_lstm, recurrence, plain, Fa, Fb, H, seq_out,
                xs, w_ih, b, w_hh, packed):
    """Phase 3, K1 at float32, one main-path layer at B=4096 and at the
    TAIL rows: its two routes in turns, K1_F32_PAIRS times (split,
    in-loop, in-loop, split; graph replays), their means and spread, the
    route it takes, and the split route's parts: the projection kernel
    (beside its plain version, one torch.matmul and its bound) and the
    recurrence on its plan (beside its plain version and its bound)."""
    out = {}
    routes = f32_routes(fused_lstm)
    for B in (TILE, TAIL):
        x = tuple(v[:, :B].contiguous() for v in xs)
        pre = "" if B == TILE else "tail_"

        def route(r):
            if r == "split":
                return lambda: routes[r](x, w_ih, b, w_hh, H, seq_out,
                                         packed=packed)
            return lambda: routes[r](x, w_ih, b, w_hh, H, seq_out)

        runs = {"split": [], "inloop": []}
        for _ in range(K1_F32_PAIRS):
            for r in ("split", "inloop", "inloop", "split"):
                runs[r].append(graph_ms(torch, route(r), reps=10))
        taken = f32_route(torch, fused_lstm, Fa + Fb, H, B)
        split_ms = statistics.mean(runs["split"])
        inloop_ms = statistics.mean(runs["inloop"])
        xproj = fused_lstm.input_projection(x, w_ih, b, packed)
        x2d = torch.cat(x, dim=-1).reshape(T * B, Fa + Fb)
        pj_ops, pj_bytes = proj_bound(Fa, Fb, H, B)
        rc_ops, rc_bytes = rec_bound("lstm_recurrence_fwd", H, B, 4,
                                     PEAK_TF32_FLOPS, TF32_PASSES)
        row = {
            "route": taken, "split_ms_runs": runs["split"],
            "inloop_ms_runs": runs["inloop"], "split_ms": split_ms,
            "inloop_ms": inloop_ms,
            # in-loop minus split, pair by pair in the order timed
            "inloop_minus_split_ms": [
                i - s_ for i, s_ in zip(runs["inloop"], runs["split"])],
            "device_ms": split_ms if taken == "split" else inloop_ms,
            "kernel_ms": cuda_ms(torch, lambda: fused_lstm.bilstm_layer_fused(
                x, w_ih, b, w_hh, H, seq_out, packed=packed)),
            "proj_ms": graph_ms(torch, lambda: fused_lstm.input_projection(
                x, w_ih, b, packed), reps=10),
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
                xproj, w_hh, H, seq_out, fused_lstm.launches), reps=10),
            "rec_plain_ms": cuda_ms(torch, lambda: plain.k1_outputs(
                plain.lstm_recurrence(xproj, w_hh, H), seq_out), reps=5),
            "rec_bound_ms": max(rc_ops, rc_bytes),
            "rec_bound_by": "operations" if rc_ops >= rc_bytes else "bytes"}
        out.update({pre + k: v for k, v in row.items()})
        del x, xproj, x2d
    out["tail_B"] = TAIL
    return out


def time_kernel(torch, fused_lstm, recurrence, plain):
    """Phase 3: each main-path launch at B=4096, through each of K1's
    routes (bfloat16 with its weights packed beforehand, as a model
    caches them; float32 also, time_k1_f32), beside the plain version
    and torch.nn.LSTM in the kernel's dtype; bfloat16 also at call_mods'
    ragged tail tile (TAIL rows: 64 blocks, fewer than the SMs, where
    B=4096 runs 256, two per SM). The kernels both with CUDA events per
    call and as device time (graph replays, the packed weights made
    before the capture)."""
    rows = []
    for name, (Fa, Fb, H, seq_out) in MAIN_PATH_LAYERS.items():
        for kernel, dname in K1_KERNELS.items():
            dtype = getattr(torch, dname)
            xs, w_ih, b, w_hh = layer_inputs(torch, Fa, Fb, H, TILE, dtype)
            packed = (fused_lstm.pack_weights(w_ih, w_hh)
                      if dtype == torch.bfloat16 else
                      fused_lstm.pack_proj_weights(w_ih, Fa))
            def call(x):
                return lambda: fused_lstm.bilstm_layer_fused(
                    x, w_ih, b, w_hh, H, seq_out, packed=packed)

            if dtype == torch.bfloat16:
                kernel_ms = cuda_ms(torch, call(xs))
                device_ms = graph_ms(torch, call(xs), reps=10)
                xt = tuple(x[:, :TAIL].contiguous() for x in xs)
                extra = {"tail_B": TAIL,
                         "tail_kernel_ms": cuda_ms(torch, call(xt)),
                         "tail_device_ms": graph_ms(torch, call(xt),
                                                    reps=10)}
                del xt
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
    training shapes, K2-K4 through the plan's cluster kernel of each dtype
    and through the streaming kernel it replaces. K4 and dW_hh take the
    plain residuals, so both sides see identical inputs."""
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in REC_KERNELS}
    checked = []
    for H in (128, 256):
        for B in (TRAIN_B, TRAIN_B - 3):
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
    take (bfloat16 must take one, float32 at most two)."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, kind in recurrence._KIND.items():
            for H in (128, 256):
                for B in (TRAIN_B, TRAIN_B - 3):
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


def time_train_step(torch, ModelConfig, ModelBiLSTM, FeatureDataset,
                    init_params, optim, train_mod, compute_dtype):
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
    model = ModelBiLSTM.from_params(init_params(cfg, SEED), cfg, "cuda",
                                    trainable=True)
    weights = list(model.parameters())
    opt = optim.Optimizer("Adam", optim.step_decay_schedule(
        1e-3, 32, 2, 0.1), weights)
    rng = np.random.default_rng(SEED)
    n = 32 * TRAIN_B
    ds = FeatureDataset(
        rng.integers(0, 4, (n, T)).astype(np.int32),
        rng.normal(size=(n, T)).astype(np.float32),
        np.abs(rng.normal(size=(n, T))).astype(np.float32),
        rng.integers(1, 30, (n, T)).astype(np.float32),
        rng.normal(size=(n, T, 16)).astype(np.float32),
        rng.integers(0, 2, n).astype(np.int32))
    dev = torch.device("cuda")
    src = train_mod.Resident(ds, dev)
    order = torch.from_numpy(rng.permutation(n)).to(dev)
    cw = torch.ones(2, device="cuda")

    def gathered(i):
        return src.batch(order[i % 32 * TRAIN_B:(i % 32 + 1) * TRAIN_B])

    fixed_batch = gathered(0)

    def step(i, get_batch):
        return train_mod.train_step(
            model, weights, opt, *get_batch(i), cw, 0.5,
            train_mod.step_generator(SEED + 1, i, dev))

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


def run_cli(*argv: str) -> dict:
    """One ``python -m deepsignal_plant_tpu_torch <argv> --verbose_stages``
    process; returns its [stages] counters and wall seconds."""
    cmd = [sys.executable, "-m", "deepsignal_plant_tpu_torch", *argv,
           "--verbose_stages"]
    env = dict(os.environ, PYTHONPATH=REPO)
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
        want["fused_bilstm_bf16"] = 5 * st["forward_tiles"]
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
    want = {k: 0 for k in fused_lstm.launches}
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
    # every float32 layer starts with one launch: the in-loop kernel's or
    # the projection kernel's
    f32_layers = (f32k["kernel_launches"]["fused_bilstm_f32_inloop"]
                  + f32k["kernel_launches"]["fused_bilstm_proj_f32"])
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
    return {"launches": launches["fused_bilstm_bf16"],
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
    want["fused_bilstm_bf16"] = 5 * st["forward_tiles"]
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
                 "fused_bilstm_bf16": 5 * st["eval_tiles"]})
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
    want["fused_bilstm_bf16"] = 5 * tiles
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
        f"apart; K1 bf16 launches {want['fused_bilstm_bf16']} = 5 x "
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
                    seed: int) -> dict:
    """A seeded fast5 run through the port's writer
    (io/fast5.write_tombo_fast5), in synth_fast5_dir's model: each read
    a random window of a random contig, events of 3-20 samples, DAC
    300-699, strands alternating. Returns the run's totals."""
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
            chrom_start=start, alignstrand="+" if r % 2 == 0 else "-")
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
    """K1 float32 layers a run launched: one in-loop or projection
    launch each."""
    kl = st["kernel_launches"]
    return kl["fused_bilstm_f32_inloop"] + kl["fused_bilstm_proj_f32"]


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
        f"{fused['kernel_launches']['fused_bilstm_bf16']} = 5 x "
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
            k_f5["kernel_launches"]["fused_bilstm_bf16"]:
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
    want["fused_bilstm_bf16"] = 5 * st["forward_tiles"]
    if len(req) != 1 or st["kernel_launches"] != want:
        fail(f"serve over the run-folder: {st}")
    log(f"serve --once over a run-folder of {FAST5_SUB_READS} fast5s: "
        f"{req[0]['sites']} sites in {req[0]['seconds']:.3f} s "
        f"({req[0]['sites_per_s']:.1f} sites/s) on one warm engine, bytes "
        f"= the call_mods CLI's ({cli_sub['wall_seconds']:.1f} s cold "
        f"process), .done written; process {st['wall_seconds']:.1f} s")
    return {"fixture": fix, "reader": reader, "extract": ext,
            "rows": n_rows,
            "call_mods": {k: v for k, v in fused.items() if k != "rows"},
            "call_mods_tsv_sites_per_s": on_tsv["sites_per_s"],
            "float32": {"sites": k_f5["sites"], "max_dp1": dp,
                        "launches": k_f5["kernel_launches"]},
            "serve": {"request": req[0], "wall_seconds": st["wall_seconds"],
                      "engine_seconds": st["engine_seconds"]}}


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
    want["fused_bilstm_bf16"] = 5 * st["forward_tiles"]
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
                         st["kernel_launches"]["fused_bilstm_bf16"],
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
                       st["kernel_launches"]["fused_bilstm_bf16"]}
        log(f"int8 on {ref}: {st['sites_per_s']:.1f} sites/s, "
            f"{int8[k]['wire_bytes_per_site']:.1f} wire bytes a site "
            f"(float16 {int8[k]['float16_wire_bytes_per_site']:.1f}); "
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
            k_st["kernel_launches"]["fused_bilstm_bf16"]:
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
    k1 = sorted(n for n in names if "fused_bilstm_bf16_kernel" in n)
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
                    "fused_bilstm_bf16": 5 * tr["eval_tiles"]})
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
        "fused_bilstm_bf16": DENOISE_LAYERS * bf["forward_tiles"]})
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
    k1_f32 = (k["kernel_launches"]["fused_bilstm_f32_inloop"]
              + k["kernel_launches"]["fused_bilstm_proj_f32"])
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
    runs = {"epoch1": run_cli("train", *common, *resumed,
                              "--max_epoch_num", "1"),
            "resume": run_cli("train", *common, *resumed,
                              "--max_epoch_num", "2", "--resume"),
            "stream": run_cli("train", *common, "--model_dir",
                              os.path.join(tmp, "stream_model"),
                              "--max_epoch_num", "1", "--stream", "yes")}
    for name, st in runs.items():
        start = (1, steps) if name == "resume" else (0, 0)
        plane = "stream" if name == "stream" else "resident"
        ran = st["steps"] - st["start_step"]
        check_launches(f"train ({name})", st["kernel_launches"], {
            "lstm_recurrence_fwd_save": 5 * ran,
            "lstm_recurrence_bwd": 5 * ran, "lstm_dw_hh": 5 * ran,
            "fused_bilstm_bf16": 5 * st["eval_tiles"]})
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


def phase8_launches(phase8: dict, name: str) -> dict:
    """A kernel's launches in phase 8's runs: the bf16 and float32
    denoise, and train's resumed and streamed epochs."""
    runs = {"denoise": phase8["bf16"],
            "denoise_float32": phase8["float32"]["kernel"],
            **{f"train_{k}": v for k, v in phase8["train"].items()}}
    return {k: v["kernel_launches"][name] for k, v in runs.items()
            if v["kernel_launches"].get(name)}


def k1_f32_parts(timings, errs, checked, launched) -> list:
    """The kernels line's entries of K1's float32 kernels (K1_F32_KERNELS),
    per 4096-row tile over the layers whose route runs each (the tail
    tile's beside): the projection kernel and K1's recurrence on the
    float32 cluster kernel (the split route), and the in-loop kernel.
    ``launched``: the float32 call_mods run's counters."""
    rows = [r for r in timings if r["kernel"] == "k1_float32"]
    parts = []

    def entry(name, source, route, ms, plain_ms, bound, library_ms):
        use = [r for r in rows if r["route"] == route]
        tail = [r for r in rows if r["tail_route"] == route]
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
            "shapes_checked": [c for c in checked if c[4] == name]})

    entry("fused_bilstm_proj_f32", "fused_bilstm.cu", "split", "proj_ms",
          "proj_plain_ms", lambda r: proj_bound(*r["F"], r["H"], TILE),
          "proj_library_ms")
    # library: torch.nn.LSTM at float32 on the same layers (cuDNN; it
    # computes the input projection too), as K2's entry takes it
    entry("fused_bilstm_rec_f32", "lstm_recurrence.cu", "split", "rec_ms",
          "rec_plain_ms", lambda r: rec_bound(
              "lstm_recurrence_fwd", r["H"], TILE, 4, PEAK_TF32_FLOPS,
              TF32_PASSES), "library_ms")
    entry("fused_bilstm_f32_inloop", "fused_bilstm.cu", "inloop",
          "inloop_ms", "plain_ms", lambda r: (r["ops_ms"], r["bytes_ms"]),
          "library_ms")
    parts[1]["plans"] = {r["layer"]: [r["rec_plan"], r["tail_rec_plan"]]
                         for r in rows}
    return parts


def k1_f32_tile(timings, errs, checked, layers) -> dict:
    """K1 at float32 as a whole, a composite of its kernels' launches
    (not a kernel): sums over the five layers of one 4096-row tile (and
    of the tail tile) of the route each layer takes and of both routes
    timed in turns; ``layers``: the float32 call_mods run's layer
    count."""
    rows = [r for r in timings if r["kernel"] == "k1_float32"]

    def total(key):
        return sum(r[key] for r in rows)

    return {
        "what": "K1 float32 per tile, a composite of its kernels",
        "kernels": list(K1_F32_KERNELS), "layers_run": layers,
        "routes": [r["route"] for r in rows],
        "tail_routes": [r["tail_route"] for r in rows],
        "device_ms": total("device_ms"), "kernel_ms": total("kernel_ms"),
        "tail_device_ms": total("tail_device_ms"),
        "split_ms": total("split_ms"), "inloop_ms": total("inloop_ms"),
        "tail_split_ms": total("tail_split_ms"),
        "tail_inloop_ms": total("tail_inloop_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                     else "bytes"),
        "ffma_bound_ms": max(total("ffma_ms"), total("bytes_ms")),
        "library_ms": total("library_ms"),
        "max_abs_err": errs["k1_float32"],
        "shapes_checked": [c for c in checked if c[4] == "k1_float32"],
        "per_layer": rows}


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
        from deepsignal_plant_tpu_torch.models.convert import (
            load_checkpoint, save_checkpoint)
        from deepsignal_plant_tpu_torch.ops import _build, fused_lstm
        from deepsignal_plant_tpu_torch.ops import lstm as plain
        from deepsignal_plant_tpu_torch.ops import optim, recurrence
        from deepsignal_plant_tpu_torch.pipeline import call_mods
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
    log(f"built native/featparse.cpp with {native.CXX} "
        f"{' '.join(native.CXX_FLAGS)}: {native.library_path().name}")
    errs, checked = check_kernel(torch, fused_lstm, recurrence, plain)
    plans = rec_plans(torch, recurrence)
    rec_errs, rec_checked = check_recurrence(torch, recurrence, plain)

    # phase 3: timing
    timings = time_kernel(torch, fused_lstm, recurrence, plain)
    forward = time_forward(torch, ModelConfig, ModelBiLSTM, Batch,
                           init_params)
    rec_timings = time_recurrence(torch, recurrence, plain)
    step_timing = {dt: time_train_step(torch, ModelConfig, ModelBiLSTM,
                                       FeatureDataset, init_params, optim,
                                       train_mod, dt)
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
    rows = [r for r in timings if r["kernel"] == "fused_bilstm_bf16"]

    def total(key):
        return sum(r[key] for r in rows)

    kernels["kernels"].append({
        "name": "fused_bilstm_bf16", "route": "cuda",
        "source": "deepsignal_plant_tpu_torch/csrc/fused_bilstm.cu",
        "replaces": "deepsignal_plant_tpu/ops/pallas_fused.py:62",
        # from the default call_mods run (phase 4, a fresh process)
        "launches": run["launches_by_kernel"]["fused_bilstm_bf16"],
        "max_abs_err": errs["fused_bilstm_bf16"], "dtype": "bfloat16",
        # times: sums over the five launches of one 4096-row tile; ms is
        # device time (graph replays), kernel_ms events per call
        "ms": total("device_ms"), "device_ms": total("device_ms"),
        "kernel_ms": total("kernel_ms"),
        "tail_device_ms": total("tail_device_ms"),
        "tail_kernel_ms": total("tail_kernel_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                     else "bytes"),
        "library_ms": total("library_ms"),
        "shapes_checked": [c for c in checked if c[4] == "fused_bilstm_bf16"],
        "phase8_launches": phase8_launches(phase8, "fused_bilstm_bf16"),
        "per_launch": rows, "model_forward": forward, "main_path": run})
    # K1's float32 kernels, launches from the float32 call_mods run; the
    # whole float32 layer route per tile rides on the projection's entry
    f32_parts = k1_f32_parts(timings, errs, checked,
                             run["f32_launches_by_kernel"])
    f32_parts[0]["k1_float32_tile"] = k1_f32_tile(timings, errs, checked,
                                                  run["f32_layers"])
    for part in f32_parts:
        part["phase8_launches"] = phase8_launches(phase8, part["name"])
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
    sys.exit(main())
