#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepsignal_plant_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, runs and
agrees with itself on the card.

    python3 chip_smoke.py          # from the repository root; one card

Phases, in order; any failure exits non-zero before the last line:

1. the card: name and power limit (nvidia-smi), torch's device name;
2. every kernel of the main path, built from csrc/ by nvcc, against its
   plain PyTorch version on the card at the main path's shapes;
3. each kernel timed with CUDA events (median of reps after warm-up)
   beside its plain version, one PyTorch library call computing the same
   function (a yardstick the port never calls) and its bound;
4. the main path through the user's entry point: ``python -m
   deepsignal_plant_tpu_torch call_mods`` on a seeded ~17.4k-row features
   TSV with a seeded random full-width both_bilstm checkpoint. The run is
   a fresh process, so its kernel launch counts start at 0; it prints
   them (--verbose_stages) and they must equal 5 per forward tile. The
   same rows then run in float32 through the kernel and through the plain
   version on the card, which must agree;
5. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package. Without a card, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T = 13
TILE = 4096
N_ROWS = 17_400            # four full 4096-row forward tiles + a ragged tail
SEED = 20261016
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores and
# the HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
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


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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


def layer_bound(Fa, Fb, H, seq_out, B, itemsize, peak_flops):
    """(ms at the peak operation rate, ms at the memory rate) of one
    layer: its products, and its compulsory bytes (each input read once,
    each output written once). The bound is the larger."""
    F = Fa + Fb
    flops = 2 * 2 * T * B * (F + H) * 4 * H
    out_T = T if seq_out else 1
    nbytes = (T * B * F * itemsize + 2 * (F + H) * 4 * H * itemsize
              + 2 * 4 * H * 4 + 2 * out_T * B * H * itemsize)
    return flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3


def check_kernel(torch, fused_lstm, bilstm_layer):
    """Phase 2: the kernel against the plain version at every main-path
    layer shape, seq_out True and False, full and ragged batch, f32 and
    bf16."""
    shapes = sorted({(Fa, Fb, H) for Fa, Fb, H, _ in
                     MAIN_PATH_LAYERS.values()})
    errs = {"float32": 0.0, "bfloat16": 0.0}
    checked = []
    for Fa, Fb, H in shapes:
        for B in (TILE, TILE - 3):
            for dname, dtype in (("float32", torch.float32),
                                 ("bfloat16", torch.bfloat16)):
                xs, w_ih, b, w_hh = layer_inputs(torch, Fa, Fb, H, B, dtype)
                for seq_out in (True, False):
                    got = fused_lstm.bilstm_layer_fused(xs, w_ih, b, w_hh, H,
                                                        seq_out)
                    torch.cuda.synchronize()
                    want = bilstm_layer(xs, w_ih, b, w_hh, H, seq_out)
                    out_T = T if seq_out else 1
                    err = 0.0
                    for g, w in zip(got, want):
                        if g.shape != (out_T, B, H) or g.dtype != dtype:
                            fail(f"kernel output {tuple(g.shape)} {g.dtype}")
                        if not torch.isfinite(g.float()).all():
                            fail("kernel output is not finite")
                        err = max(err, (g.float() - w.float()).abs().max()
                                  .item())
                    log(f"fused_bilstm F=({Fa},{Fb}) H={H} B={B} {dname} "
                        f"seq_out={seq_out}: max|kernel-plain| = {err:.3g} "
                        f"(tolerance {TOL[dname]:g})")
                    if err > TOL[dname]:
                        fail(f"fused_bilstm disagrees with its plain version "
                             f"by {err} > {TOL[dname]}")
                    errs[dname] = max(errs[dname], err)
                    checked.append([Fa, Fb, H, B, dname, seq_out])
    return errs, checked


def time_kernel(torch, fused_lstm, bilstm_layer):
    """Phase 3: each main-path launch at B=4096 in bf16."""
    rows = []
    for name, (Fa, Fb, H, seq_out) in MAIN_PATH_LAYERS.items():
        xs, w_ih, b, w_hh = layer_inputs(torch, Fa, Fb, H, TILE,
                                         torch.bfloat16)
        kernel_ms = cuda_ms(torch, lambda: fused_lstm.bilstm_layer_fused(
            xs, w_ih, b, w_hh, H, seq_out))
        plain_ms = cuda_ms(torch, lambda: bilstm_layer(
            xs, w_ih, b, w_hh, H, seq_out), reps=10)
        # library yardstick: cuDNN's bidirectional LSTM on the concatenated
        # input, same weights (torch layout), bf16
        lstm = torch.nn.LSTM(Fa + Fb, H, bidirectional=True).to(
            "cuda", torch.bfloat16)
        with torch.no_grad():
            for d, sfx in enumerate(("", "_reverse")):
                getattr(lstm, "weight_ih_l0" + sfx).copy_(w_ih[d].t())
                getattr(lstm, "weight_hh_l0" + sfx).copy_(w_hh[d].t())
                getattr(lstm, "bias_ih_l0" + sfx).copy_(b[d])
                getattr(lstm, "bias_hh_l0" + sfx).zero_()
        x_cat = torch.cat(xs, dim=-1).contiguous()
        # torch flattens no bf16 RNN weights (cudnn.is_acceptable takes
        # f16/f32/f64 only), so each call also compacts the layer's
        # weights (<= 3 MB of copies) and warns about it; the time counts
        with torch.no_grad(), warnings.catch_warnings():
            warnings.filterwarnings("ignore", "RNN module weights")
            library_ms = cuda_ms(torch, lambda: lstm(x_cat))
        ops_ms, bytes_ms = layer_bound(Fa, Fb, H, seq_out, TILE, 2,
                                       PEAK_BF16_FLOPS)
        row = {"layer": name, "F": [Fa, Fb], "H": H, "B": TILE,
               "seq_out": seq_out, "dtype": "bfloat16",
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "ops_ms": ops_ms,
               "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        log("timing " + json.dumps(row))
        rows.append(row)
        del lstm, x_cat, xs, w_ih, b, w_hh
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


def write_features(path: str, n: int, seed: int) -> None:
    """A seeded 12-column features TSV, rows grouped by read, labels
    alternating with a shift of the means and signals."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    labels = np.arange(n) % 2
    shift = np.where(labels == 1, 0.8, -0.8)
    codes = rng.integers(0, 4, (n, T))
    codes[:, T // 2] = 1                                   # centre C
    means = np.around(shift[:, None] + rng.normal(0, 0.3, (n, T)), 6)
    stds = np.around(np.abs(rng.normal(0.5, 0.1, (n, T))), 6)
    lens = rng.integers(3, 30, (n, T))
    sig = np.around(shift[:, None, None] + rng.normal(0, 0.5, (n, T, 16)), 6)
    with open(path, "w") as fh:
        for i in range(n):
            r = i // 20
            fh.write("\t".join([
                "chr1", str(10 * i), "+-"[r % 2], str(10 * i),
                f"read_{r:05d}", "t", "".join(bases[codes[i]]),
                ",".join(map(str, means[i].tolist())),
                ",".join(map(str, stds[i].tolist())),
                ",".join(map(str, lens[i].tolist())),
                ";".join(",".join(map(str, row)) for row in sig[i].tolist()),
                str(labels[i])]) + "\n")


def run_call_mods(tsv: str, ckpt: str, out: str, *extra: str) -> dict:
    """One ``python -m deepsignal_plant_tpu_torch call_mods`` process;
    returns its [stages] counters plus the rows it wrote."""
    cmd = [sys.executable, "-m", "deepsignal_plant_tpu_torch", "call_mods",
           "-i", tsv, "-m", ckpt, "-o", out, "--verbose_stages", *extra]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        fail("call_mods exited {}:\n{}\n{}".format(
            proc.returncode, proc.stdout[-4000:], proc.stderr[-4000:]))
    stages = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("[stages] ")]
    if len(stages) != 1:
        fail("call_mods printed no [stages] line:\n" + proc.stdout[-4000:])
    st = json.loads(stages[0][len("[stages] "):])
    st["wall_seconds"] = time.time() - t0
    with open(out) as fh:
        st["rows"] = [ln.rstrip("\n").split("\t") for ln in fh]
    log("call_mods {}: {}".format(" ".join(extra) or "(defaults)",
                                  json.dumps({k: v for k, v in st.items()
                                              if k != "rows"})))
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


def check_main_path(tmp: str, cfg_cls, init_params, save_checkpoint):
    """Phase 4: the CLI end to end on the card."""
    cfg = cfg_cls(dropout_rate=0.0)
    ckpt = os.path.join(tmp, "both_bilstm.ckpt.npz")
    save_checkpoint(ckpt, init_params(cfg, SEED), cfg)
    tsv = os.path.join(tmp, "features.tsv")
    write_features(tsv, N_ROWS, SEED)
    tiles = -(-N_ROWS // TILE)

    main = run_call_mods(tsv, ckpt, os.path.join(tmp, "calls.tsv"))
    p_main = check_rows(main, N_ROWS)
    if main["compute_dtype"] != "bfloat16" or main["recurrence"] != "kernel":
        fail(f"defaults did not run bf16 through the kernel: {main}")
    if main["forward_tiles"] != tiles:
        fail(f"{main['forward_tiles']} forward tiles, expected {tiles}")
    launches = main["kernel_launches"]["fused_bilstm"]
    if launches != 5 * main["forward_tiles"]:
        fail(f"fused_bilstm launched {launches} times for "
             f"{main['forward_tiles']} forward tiles (expected 5 each)")

    f32k = run_call_mods(tsv, ckpt, os.path.join(tmp, "calls_f32k.tsv"),
                         "--compute_dtype", "float32", "--recurrence",
                         "kernel")
    f32p = run_call_mods(tsv, ckpt, os.path.join(tmp, "calls_f32p.tsv"),
                         "--compute_dtype", "float32", "--recurrence", "scan")
    if f32p["kernel_launches"]["fused_bilstm"] != 0:
        fail("the plain (scan) run launched the kernel")
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
    return {"launches": launches, "forward_tiles": main["forward_tiles"],
            "sites": main["sites"], "seconds": main["seconds"],
            "device_seconds": main["device_seconds"],
            "format_seconds": main["format_seconds"],
            "sites_per_s": main["sites"] / main["seconds"],
            "f32_kernel_vs_plain_max_dp1": dp_kp,
            "bf16_vs_f32_agreement": agree, "bf16_vs_f32_max_dp1": dp_bf}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one card")
    sys.path.insert(0, REPO)
    try:
        from deepsignal_plant_tpu_torch.config import ModelConfig
        from deepsignal_plant_tpu_torch.models.bilstm import (
            Batch, ModelBiLSTM, forward_flops_per_site, init_params)
        from deepsignal_plant_tpu_torch.models.convert import save_checkpoint
        from deepsignal_plant_tpu_torch.ops import _build, fused_lstm
        from deepsignal_plant_tpu_torch.ops.lstm import bilstm_layer
    except ImportError as exc:
        fail(f"the deepsignal_plant_tpu_torch package is not beside this "
             f"script ({exc})")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 is full f32

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}), device 0 = {kind}")

    # phase 2: build and check
    t0 = time.time()
    _build.load("fused_bilstm")
    log(f"built csrc/fused_bilstm.cu in {time.time() - t0:.1f} s: "
        + _build.library_path("fused_bilstm").with_suffix(".so.log")
        .read_text().strip().replace("\n", " | ")[-600:])
    errs, checked = check_kernel(torch, fused_lstm, bilstm_layer)

    # phase 3: timing
    timings = time_kernel(torch, fused_lstm, bilstm_layer)
    forward = time_forward(torch, ModelConfig, ModelBiLSTM, Batch,
                           init_params)

    # phase 4: the main path; its counts start at 0 in the fresh process
    fused_lstm.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        run = check_main_path(tmp, ModelConfig, init_params, save_checkpoint)
    if fused_lstm.launches != 0:
        fail("phase 4 launched kernels in this process")
    flops = forward_flops_per_site(ModelConfig())
    log(f"call_mods: {run['sites_per_s']:.1f} sites/s on {smi} "
        f"({run['sites']} sites in {run['seconds']:.3f} s, of which "
        f"{run['device_seconds']:.3f} s upload+forward+readback and "
        f"{run['format_seconds']:.3f} s formatting; model "
        f"{flops / 1e9:.3f} GFLOP/site -> "
        f"{run['sites_per_s'] * flops / 1e12:.3f} TFLOP/s)")

    def total(key):
        return sum(r[key] for r in timings)

    kernels = {"kernels": [{
        "name": "fused_bilstm", "route": "cuda",
        "source": "deepsignal_plant_tpu_torch/csrc/fused_bilstm.cu",
        "replaces": "deepsignal_plant_tpu/ops/pallas_fused.py:62",
        "launches": run["launches"],
        "max_abs_err": max(errs.values()),
        "max_abs_err_float32": errs["float32"],
        "max_abs_err_bfloat16": errs["bfloat16"],
        # times: sums over the five launches of one 4096-row bf16 tile
        "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                     else "bytes"),
        "library_ms": total("library_ms"),
        "shapes_checked": checked, "per_launch": timings,
        "model_forward": forward, "main_path": run}]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
