"""The trained-checkpoint agreement gates of the PyTorch/CUDA port
(deepsignal_plant_tpu_torch), in the table format of
docs/TRAINED_GATES.md.

The fixture comes from benchmarks/trained_ckpt.py (a both_bilstm at full
width, hidden 256, trained to valid accuracy 1.0 on synthetic
methylation reads; 4,493 held-out sites whose probabilities hug 0 and
1, so a numeric perturbation that matters flips calls). Two steps:

    # 1. on a host with the JAX package (CPU): the exact-numerics base
    #    (float32 wire, float32 compute, the plain scan recurrence), JAX's
    #    int8 wire at float32 compute, and the files the card needs
    #    copied into --gates (small enough for a chip call's copy)
    python torch_trained_gates.py base \\
        --fixture build/trained_fixture --gates build/trained_gates

    # 2. on the card: the port's call_mods engine on the same sites
    python torch_trained_gates.py card --gates build/trained_gates

    # 3. on the card: the port's denoise on the fixture's training set
    #    with 20% of its labels flipped (docs/DENOISE_EVAL.md's protocol)
    python torch_trained_gates.py denoise --gates build/trained_gates

Step 2 runs the port at float16 wire + bfloat16 compute (the default),
int8 wire + bfloat16, float16 and int8 wires + float32 compute, and
float32 wire + float32 compute, each at device_batch 32768 (one batch of
4,493 sites in a 4096-row and a 397-row tile), 4096 (two batches) and
3477 (its second batch a 1,016-row tile, the tail tile of
chip_smoke.py's main path), and compares each run with the base: call
agreement, flips (listed with their inputs), mean and max |dP1|; the
int8+f32 runs also against JAX's int8 run. It prints the table and one
JSON line, and writes the JSON to chiprun_out/torch_trained_gates.json.
It needs a card and imports nothing of JAX; step 1 calls the JAX
package's CLI in a subprocess.

Step 3 flips the label of each training row with probability 0.2 (numpy
seed 77, as benchmarks/denoise_eval.py does), runs the port's ``denoise
--iterations 3 --rounds 2 --epoch_num 3 --seed 77`` (signal_bilstm, the
CLI's defaults otherwise) in a fresh process, and scores its output
against the true labels, which the fixture's read names carry
(methread_* / unmethread_*): label-1 and label-0 purity before and
after, rows kept, wall time, the run's counters. The gate: label-1
purity after >= 99%. It writes chiprun_out/torch_trained_gates_denoise
.json.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
VARIANTS = {"f16+bf16": ("float16", "bfloat16"),
            "int8+bf16": ("int8", "bfloat16"),
            "f16+f32": ("float16", "float32"),
            "int8+f32": ("int8", "float32"),
            "f32+f32": ("float32", "float32")}
DEVICE_BATCHES = (32768, 4096, 3477)
GATE_FILES = ("eval_features.tsv", "model.trained.npz", "meta.json",
              "train.tsv")
# step 3: docs/DENOISE_EVAL.md's protocol
DENOISE_FLIP, DENOISE_SEED = 0.2, 77
DENOISE_ARGS = ("--iterations", "3", "--rounds", "2", "--epoch_num", "3",
                "--seed", str(DENOISE_SEED))
DENOISE_GATE_PCT = 99.0


def read_calls(path: str) -> dict:
    """(chrom, pos, strand, readname) -> (P0, P1, the row)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            c = line.rstrip("\n").split("\t")
            out[(c[0], c[1], c[2], c[4])] = (float(c[6]), float(c[7]), line)
    return out


def compare(base: dict, other: dict) -> dict:
    if base.keys() != other.keys():
        raise SystemExit("the runs called different sites")
    flips = [k for k in base
             if (base[k][1] > base[k][0]) != (other[k][1] > other[k][0])]
    deltas = [abs(base[k][1] - other[k][1]) for k in base]
    n = len(base)
    return {"rows": n, "agreement_pct": 100.0 * (n - len(flips)) / n,
            "flips": len(flips), "mean_abs_dp1": sum(deltas) / n,
            "max_abs_dp1": max(deltas),
            "flipped": [{"base": base[k][2].rstrip("\n"),
                         "run": other[k][2].rstrip("\n")} for k in flips]}


def margins(base: dict) -> dict:
    m = sorted(abs(v[1] - 0.5) for v in base.values())
    n = len(m)
    return {"rows": n, "median_margin": m[n // 2],
            "pct_margin_gt_0.4": 100.0 * sum(x > 0.4 for x in m) / n,
            "pct_margin_gt_0.1": 100.0 * sum(x > 0.1 for x in m) / n,
            "pct_called_methylated": 100.0 * sum(
                v[1] > v[0] for v in base.values()) / n}


def base(fixture: str, gates: str) -> None:
    """The JAX package's float32 scan base, and its int8 wire at float32
    compute (the same numerics as the port's int8+f32 run), on the
    CPU."""
    os.makedirs(gates, exist_ok=True)
    for f in GATE_FILES:
        shutil.copy(os.path.join(fixture, f), gates)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    seconds = {}
    for name, wire in (("jax_base", "float32"), ("jax_int8", "int8")):
        t0 = time.time()
        subprocess.run(
            [sys.executable, "-m", "deepsignal_plant_tpu", "call_mods",
             "-i", os.path.join(gates, "eval_features.tsv"), "-m",
             os.path.join(gates, "model.trained.npz"), "-o",
             os.path.join(gates, f"{name}.tsv"), "--transfer_dtype", wire,
             "--compute_dtype", "float32", "--recurrence", "scan"],
            env=env, check=True, cwd=REPO)
        seconds[name] = time.time() - t0
    base_calls = read_calls(os.path.join(gates, "jax_base.tsv"))
    int8 = compare(base_calls, read_calls(os.path.join(gates,
                                                       "jax_int8.tsv")))
    print(json.dumps({"seconds": seconds, "margins": margins(base_calls),
                      "jax_int8_vs_base": int8}))


def card(gates: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the gates run on the card")
    sys.path.insert(0, REPO)
    from deepsignal_plant_tpu_torch.config import CallConfig, ModelConfig
    from deepsignal_plant_tpu_torch.pipeline.call_mods import CallModsEngine
    smi = card_name()
    feats = os.path.join(gates, "eval_features.tsv")
    ckpt = os.path.join(gates, "model.trained.npz")
    base_calls = read_calls(os.path.join(gates, "jax_base.tsv"))
    jax_int8 = read_calls(os.path.join(gates, "jax_int8.tsv"))
    with open(os.path.join(gates, "meta.json")) as fh:
        meta = json.load(fh)
    out_dir = os.path.join(REPO, "chiprun_out", "torch_trained_gates")
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for name, (wire, compute) in VARIANTS.items():
        cfg = ModelConfig(dropout_rate=0.0, compute_dtype=compute)
        for db in DEVICE_BATCHES:
            eng = CallModsEngine(ckpt, cfg, CallConfig(
                device_batch=db, transfer_dtype=wire), "cuda")
            out = os.path.join(out_dir, f"{name}.{db}.tsv")
            st = eng.run_features_file(feats, out)
            calls = read_calls(out)
            res = compare(base_calls, calls)
            if name == "int8+f32":
                # the port's int8 wire against JAX's on the same sites
                res["max_abs_dp1_vs_jax_int8"] = max(
                    abs(calls[k][1] - jax_int8[k][1]) for k in calls)
            rows.append({"variant": name, "wire": wire, "compute": compute,
                         "recurrence": "kernel", "device_batch": db,
                         "forward_tiles": st.forward_tiles,
                         "seconds": st.seconds, **res})
    summary = {"card": smi, "kind": torch.cuda.get_device_name(0),
               "meta": {k: meta[k] for k in ("best_valid_accuracy",
                                             "train_rows", "eval_rows",
                                             "seed")},
               "base": "JAX package, float32 wire, float32 compute, scan "
                       "(CPU)",
               "margins": margins(base_calls),
               "jax_int8_vs_base": compare(base_calls, jax_int8),
               "gates": rows}
    print(f"card: {smi}")
    print("| variant | wire | compute | device_batch | agreement | flips | "
          "mean abs dP1 | max abs dP1 |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['variant']} | {r['wire']} | {r['compute']} | "
              f"{r['device_batch']} | {r['agreement_pct']:.4f}% | "
              f"{r['flips']} | {r['mean_abs_dp1']:.3g} | "
              f"{r['max_abs_dp1']:.6f} |")
    for r in rows:
        for f in r["flipped"]:
            print(f"flip ({r['variant']}, {r['device_batch']}): base "
                  f"{f['base']} | run {f['run']}")
    j8 = summary["jax_int8_vs_base"]
    print(f"JAX int8 (float32, CPU) vs base: {j8['flips']} flips, max "
          f"|dP1| {j8['max_abs_dp1']:.6f}; port int8+f32 vs JAX int8: max "
          f"|dP1| " + ", ".join(f"{r['max_abs_dp1_vs_jax_int8']:.2g}"
                                for r in rows if r["variant"] == "int8+f32"))
    with open(os.path.join(REPO, "chiprun_out",
                           "torch_trained_gates.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "gates"}))


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def flip_labels(src: str, dst: str) -> int:
    """Flip each row's label with probability DENOISE_FLIP (one seeded
    draw a row); returns the rows flipped."""
    import numpy as np
    with open(src) as fh:
        rows = fh.read().splitlines()
    flip = np.random.default_rng(DENOISE_SEED).random(len(rows)) \
        < DENOISE_FLIP
    with open(dst, "w") as fh:
        for row, f in zip(rows, flip):
            cols = row.split("\t")
            if f:
                cols[-1] = "1" if cols[-1] == "0" else "0"
            fh.write("\t".join(cols) + "\n")
    return int(flip.sum())


def purity(path: str) -> dict:
    """Rows per label column, and the share of each whose read is of
    that cohort (methread_* is methylated)."""
    n, right = {"0": 0, "1": 0}, {"0": 0, "1": 0}
    with open(path) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            true = "1" if cols[4].startswith("methread") else "0"
            n[cols[-1]] += 1
            right[cols[-1]] += true == cols[-1]
    return {"rows": n["0"] + n["1"], "label1_rows": n["1"],
            "label1_purity_pct": 100.0 * right["1"] / max(n["1"], 1),
            "label0_purity_pct": 100.0 * right["0"] / max(n["0"], 1)}


def denoise(gates: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the gate runs on the card")
    smi = card_name()
    with tempfile.TemporaryDirectory() as tmp:
        noisy = os.path.join(tmp, "train_noisy.tsv")
        flipped = flip_labels(os.path.join(gates, "train.tsv"), noisy)
        before = purity(noisy)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "deepsignal_plant_tpu_torch", "denoise",
             "--train_file", noisy, *DENOISE_ARGS, "--verbose_stages"],
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
            capture_output=True, text=True)
        wall = time.time() - t0
        if proc.returncode != 0:
            raise SystemExit("denoise failed:\n" + proc.stdout[-3000:]
                             + proc.stderr[-3000:])
        stages = json.loads(next(
            ln for ln in proc.stdout.splitlines()
            if ln.startswith("[stages] "))[len("[stages] "):])
        after = purity(stages["final_file"])
    res = {"card": smi, "kind": torch.cuda.get_device_name(0),
           "input_rows": before["rows"], "flipped": flipped,
           "flip_frac": DENOISE_FLIP, "args": " ".join(DENOISE_ARGS),
           "before": before, "after": after, "wall_seconds": wall,
           "gate_label1_purity_pct": DENOISE_GATE_PCT,
           "stages": {k: v for k, v in stages.items()
                      if k != "final_file"}}
    print(f"card: {smi}")
    print(f"denoise {res['args']} on {before['rows']} rows "
          f"({flipped} labels flipped): label-1 purity "
          f"{before['label1_purity_pct']:.2f}% -> "
          f"{after['label1_purity_pct']:.2f}%, label-0 "
          f"{before['label0_purity_pct']:.2f}% -> "
          f"{after['label0_purity_pct']:.2f}%, {after['rows']} rows kept "
          f"({after['label1_rows']} label 1); {wall:.1f} s wall, "
          f"{stages['mini_trainings']} mini-trainings")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out",
                           "torch_trained_gates_denoise.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))
    if after["label1_purity_pct"] < DENOISE_GATE_PCT:
        raise SystemExit(f"label-1 purity {after['label1_purity_pct']:.2f}%"
                         f" < {DENOISE_GATE_PCT}%")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("step", choices=["base", "card", "denoise"])
    ap.add_argument("--fixture", default=os.path.join(
        REPO, "build", "trained_fixture"))
    ap.add_argument("--gates", default=os.path.join(
        REPO, "build", "trained_gates"))
    args = ap.parse_args()
    if args.step == "base":
        base(args.fixture, args.gates)
    elif args.step == "card":
        card(args.gates)
    else:
        denoise(args.gates)


if __name__ == "__main__":
    main()
