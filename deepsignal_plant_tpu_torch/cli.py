"""deepsignal_plant_tpu_torch CLI (counterpart of
deepsignal_plant_tpu/cli.py:20-60 and :187-392).

Every subcommand is ported: ``extract`` (TSV and the .npz containers),
``call_mods`` and ``serve`` on features TSVs, .npz feature batches and
fast5 directories, ``train`` on features TSVs and v1 .npz batches (with
``--resume``, ``--stream`` and the spill plane), ``denoise``,
``call_freq`` and the ``tools`` set. They take the JAX package's flags
with their defaults, plus ``--device`` (and ``--verbose_stages`` where a
run has counters to print). Under a multi-process launch (``torchrun``,
WORLD_SIZE > 1) ``main`` starts the process group before the subcommand
and ends it after (parallel/dist.py): NCCL for a command on the card,
gloo for one on the CPU or the host alone.
"""
from __future__ import annotations

import argparse
import sys

from ._version import DEEPSIGNAL_PLANT_TPU_TORCH_VERSION


def device_arg(value: str) -> str:
    """argparse type of ``--device``: cuda, cuda:<n> or cpu
    (utils/device.resolve_devices reads it for call_mods, serve, train
    and denoise, resolve_device for call_freq's --device_agg)."""
    if value in ("cuda", "cpu") or (value.startswith("cuda:")
                                    and value[5:].isdigit()):
        return value
    raise argparse.ArgumentTypeError(
        f"invalid device {value!r} (choose cuda, cuda:<n> or cpu)")


def display_args(args):
    print("# ===============================================")
    print("## parameters: ")
    for k, v in vars(args).items():
        if k != "func":
            print("{}:\n\t{}".format(k, v))
    print("# ===============================================")


def _add_model_args(p, dropout_default: float, model_type_default="both_bilstm",
                    compute_dtype_default="float32"):
    p.add_argument("--model_type", type=str, default=model_type_default,
                   choices=["both_bilstm", "seq_bilstm", "signal_bilstm"],
                   help="model variant, default %(default)s")
    p.add_argument("--seq_len", type=int, default=13,
                   help="len of kmer. default 13")
    p.add_argument("--signal_len", type=int, default=16,
                   help="signal num of one base, default 16")
    p.add_argument("--layernum1", type=int, default=3,
                   help="lstm layer num for combined feature, default 3")
    p.add_argument("--layernum2", type=int, default=1,
                   help="lstm layer num for seq/signal branch, default 1")
    p.add_argument("--class_num", type=int, default=2)
    p.add_argument("--dropout_rate", type=float, default=dropout_default)
    p.add_argument("--n_vocab", type=int, default=16)
    p.add_argument("--n_embed", type=int, default=4)
    p.add_argument("--is_base", type=str, default="yes")
    p.add_argument("--is_signallen", type=str, default="yes")
    p.add_argument("--hid_rnn", type=int, default=256,
                   help="BiLSTM hidden size, default 256")
    p.add_argument("--recurrence", type=str, default="auto",
                   choices=["auto", "scan", "kernel", "pallas"],
                   help="BiLSTM layer: kernel (the hand-written CUDA "
                        "kernel; pallas and auto name it too) or scan (the "
                        "plain PyTorch loop). On the CPU both run the "
                        "plain loop")
    p.add_argument("--compute_dtype", type=str,
                   default=compute_dtype_default,
                   choices=["auto", "float32", "bfloat16"],
                   help="on-device math dtype (default %(default)s). "
                        "bfloat16 stores x, W and h in bf16; the kernel "
                        "keeps products, gate math and cell states in "
                        "f32, and logits upcast to f32 before softmax. "
                        "auto = bfloat16 on cuda, float32 on cpu")


def _add_f5_args(p):
    p.add_argument("--recursively", "-r", type=str, default="yes")
    p.add_argument("--corrected_group", type=str,
                   default="RawGenomeCorrected_000")
    p.add_argument("--basecall_subgroup", type=str,
                   default="BaseCalled_template")
    p.add_argument("--is_dna", type=str, default="yes")
    p.add_argument("--normalize_method", type=str,
                   choices=["mad", "zscore"], default="mad")
    p.add_argument("--motifs", type=str, default="CG")
    p.add_argument("--mod_loc", type=int, default=0)
    p.add_argument("--region", type=str, default=None)
    p.add_argument("--positions", type=str, default=None)
    p.add_argument("--reference_path", type=str, default=None)
    p.add_argument("--downsample", type=str, default="even",
                   choices=["even", "compat"],
                   help="per-base signal downsampling: deterministic "
                        "evenly-spaced (even) or reference-compatible "
                        "random (compat)")


def main_extract(args):
    from .pipeline.extract import (ExtractContext, extract_features,
                                   extract_options_from_args)
    from .utils.bases import str2bool
    display_args(args)
    ctx = ExtractContext.build(
        extract_options_from_args(args, args.methy_label),
        str2bool(args.is_dna))
    return extract_features(
        args.fast5_dir, str2bool(args.recursively), ctx, args.write_path,
        args.nproc, args.f5_batch_size, str2bool(args.w_is_dir),
        args.w_batch_num, args.gzip, seed=args.seed,
        out_format=args.w_format)


def main_call_mods(args):
    from .pipeline.call_mods import call_mods
    display_args(args)
    return call_mods(args)


def main_serve(args):
    from .pipeline.serve import serve
    display_args(args)
    return serve(args)


def main_call_freq(args):
    from .pipeline.call_freq import call_mods_frequency_to_file
    display_args(args)
    return call_mods_frequency_to_file(args)


def main_train(args):
    from .pipeline.train import train
    display_args(args)
    return train(args)


def main_denoise(args):
    from .pipeline.denoise import denoise
    display_args(args)
    return denoise(args)


def _add_device_args(p, every_card: bool = False):
    card = ("every visible card in this process (CUDA_VISIBLE_DEVICES "
            "chooses them), each batch shared out over them"
            if every_card else "the card")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help=f"run on {card} (cuda, the default; "
                        "cuda:<LOCAL_RANK> under a multi-process launch, "
                        "or the one card named by cuda:<n>) or on the CPU "
                        "(cpu) with the plain PyTorch versions of the "
                        "kernels")
    p.add_argument("--verbose_stages", action="store_true", default=False,
                   help="print a JSON line of run counters at the end: "
                        "kernel launches, steps or tiles, stage seconds "
                        "(call_mods: the seconds of each engine span, "
                        "parse_wait, batch, upload, forward, readback, "
                        "emit and drain, and unfed_seconds: "
                        "utils/prof.py)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deepsignal_plant_tpu_torch",
        description="deepsignal_plant_tpu_torch detects 5mC from nanopore "
                    "reads of plants on an NVIDIA GPU:\n"
                    "\textract: extract features from tombo fast5s\n"
                    "\tcall_mods: call modifications\n"
                    "\tserve: call_mods over a watched directory\n"
                    "\tcall_freq: modification frequency per site\n"
                    "\ttrain: train a model\n"
                    "\tdenoise: clean training samples by cross-rank\n"
                    "\ttools: post-processing utilities",
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("-v", "--version", action="version",
                        version="deepsignal_plant_tpu_torch version: {}".format(
                            DEEPSIGNAL_PLANT_TPU_TORCH_VERSION))
    subparsers = parser.add_subparsers(title="modules")

    # ---- extract ----
    p = subparsers.add_parser("extract",
                              description="extract features from corrected "
                                          "(tombo) fast5s")
    p.add_argument("--fast5_dir", "-i", type=str, required=True)
    _add_f5_args(p)
    p.add_argument("--seq_len", type=int, default=13,
                   help="len of kmer. default 13")
    p.add_argument("--signal_len", type=int, default=16,
                   help="signals per base, default 16")
    p.add_argument("--methy_label", type=int, choices=[1, 0], default=1)
    p.add_argument("--write_path", "-o", type=str, required=True)
    p.add_argument("--w_is_dir", type=str, default="no")
    p.add_argument("--w_batch_num", type=int, default=200)
    p.add_argument("--w_format", type=str, default="tsv",
                   choices=["tsv", "npz", "npz_wire", "npz_packed"],
                   help="tsv: reference-compatible text; npz: one v1 .npz "
                        "per fast5 batch (float32 arrays; training, tools, "
                        "call_mods); npz_wire: v2 (the float16 wire per "
                        "site); npz_packed: v3 (the read-packed float16 "
                        "wire, call_mods' fastest input). The npz formats "
                        "write a directory")
    p.add_argument("--gzip", action="store_true", default=False)
    p.add_argument("--nproc", "-p", type=int, default=4)
    p.add_argument("--f5_batch_size", type=int, default=30)
    p.add_argument("--seed", type=int, default=None,
                   help="seed the per-batch RNG of --downsample compat "
                        "for reproducible extraction")
    p.set_defaults(func=main_extract)

    # ---- call_mods ----
    p = subparsers.add_parser("call_mods", description="call modifications")
    p.add_argument("--input_path", "-i", type=str, required=True,
                   help="features TSV (plain or .gz) from extract, an "
                        ".npz feature batch or a directory of them (one "
                        "container version), or a fast5 directory")
    p.add_argument("--f5_batch_size", type=int, default=30)
    p.add_argument("--model_path", "-m", type=str, required=True,
                   help=".ckpt (torch) or .ckpt.npz (native) checkpoint")
    _add_model_args(p, dropout_default=0.0, compute_dtype_default="auto")
    _add_device_args(p, every_card=True)
    p.add_argument("--batch_size", "-b", type=int, default=512,
                   help="accepted for reference CLI compatibility")
    p.add_argument("--device_batch", type=int, default=None,
                   help="sites parsed, uploaded and called per step "
                        "(default 32768); the forward runs in 4096-row "
                        "tiles")
    p.add_argument("--transfer_dtype", type=str, default="auto",
                   choices=["auto", "float32", "float16", "int8"],
                   help="host->device wire format: auto = float16 (cast "
                        "on the host, upcast on the device); float32 for "
                        "exact-parity runs; int8: means, stds and signals "
                        "quantized per batch and field (dequantized on "
                        "the device)")
    p.add_argument("--parse_workers", type=int, default=None,
                   help="native parser threads (default: the CPU count, "
                        "2 to 4)")
    p.add_argument("--dispatch_workers", type=int, default=8,
                   help="accepted for JAX CLI compatibility: the port "
                        "launches every kernel from the main thread, "
                        "which overlaps the card with the host through "
                        "CUDA streams (the model's weight cache and "
                        "launch counters are not thread-safe)")
    p.add_argument("--packed_wire", type=str, default="auto",
                   choices=["auto", "force", "off"],
                   help="accepted for JAX CLI compatibility: the "
                        "float16 wire always ships the read-packed wire "
                        "(per-base arrays uploaded once, 13-mer windows "
                        "gathered on the card), which measured no slower "
                        "than per-site windows on sparse input")
    p.add_argument("--device_resident", type=str, default="never",
                   choices=["never", "always"],
                   help="always: upload segments of up to 32 device "
                        "batches once each, run their forwards from the "
                        "device and read each segment's probabilities "
                        "back once (TSV, v2 and v3 .npz inputs; v1 "
                        "raises)")
    p.add_argument("--result_file", "-o", type=str, required=True)
    p.add_argument("--gzip", action="store_true", default=False)
    _add_f5_args(p)
    p.add_argument("--nproc", "-p", type=int, default=4)
    p.add_argument("--nproc_gpu", type=int, default=2,
                   help="accepted for reference CLI compatibility (unused)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run (Chrome "
                        "trace JSON) into this directory")
    p.set_defaults(func=main_call_mods)

    # ---- serve (watch-directory call_mods; not in the reference) ----
    p = subparsers.add_parser(
        "serve",
        description="long-running call_mods over a watched directory: one "
                    "warm engine (checkpoint, kernels and CUDA brought up "
                    "once) calls each feature file (.tsv/.npz/.tsv.gz) as "
                    "it lands; outputs + .done/.failed markers land in "
                    "--result_dir; stable-size pickup, at-most-once "
                    "semantics across restarts, graceful SIGTERM; a "
                    "directory holding fast5s is a run-folder, called "
                    "through the fused fast5 path")
    p.add_argument("--watch_dir", "-i", type=str, required=True)
    p.add_argument("--result_dir", "-o", type=str, required=True)
    p.add_argument("--model_path", "-m", type=str, required=True)
    p.add_argument("--poll_s", type=float, default=2.0,
                   help="poll interval seconds, default %(default)s")
    p.add_argument("--once", action="store_true", default=False,
                   help="process the current backlog and exit")
    p.add_argument("--require_complete", action="store_true", default=False,
                   help="only process inputs X with a producer-written "
                        "X.complete marker (exact pickup for rsync/scp "
                        "deposits); default also accepts inputs whose "
                        "size+mtime are stable across two polls. A "
                        "marker always makes X ready immediately")
    p.add_argument("--batch_size", "-b", type=int, default=512,
                   help="accepted for reference CLI compatibility")
    p.add_argument("--device_batch", type=int, default=None,
                   help="sites parsed, uploaded and called per step "
                        "(default 32768)")
    p.add_argument("--transfer_dtype", type=str, default="auto",
                   choices=["auto", "float32", "float16", "int8"],
                   help="host->device wire format: auto = float16; "
                        "float32 for exact-parity runs; int8 quantized "
                        "per batch and field")
    p.add_argument("--parse_workers", type=int, default=None,
                   help="native parser threads (default: the CPU count, "
                        "2 to 4)")
    p.add_argument("--dispatch_workers", type=int, default=8,
                   help="accepted for JAX CLI compatibility (unused)")
    p.add_argument("--packed_wire", type=str, default="auto",
                   choices=["auto", "force", "off"],
                   help="accepted for JAX CLI compatibility: the float16 "
                        "wire always ships the read-packed wire")
    p.add_argument("--gzip", action="store_true", default=False)
    _add_model_args(p, dropout_default=0.0, compute_dtype_default="auto")
    _add_device_args(p, every_card=True)
    p.add_argument("--nproc", "-p", type=int, default=4)
    p.add_argument("--f5_batch_size", type=int, default=30)
    _add_f5_args(p)
    p.set_defaults(func=main_serve)

    # ---- call_freq ----
    p = subparsers.add_parser("call_freq",
                              description="calculate modification frequency "
                                          "at genome level")
    p.add_argument("--input_path", "-i", action="append", type=str,
                   required=True)
    p.add_argument("--file_uid", type=str, default=None)
    p.add_argument("--result_file", "-o", type=str, required=True)
    p.add_argument("--contigs", type=str, default=None)
    p.add_argument("--nproc", type=int, default=1)
    p.add_argument("--bed", action="store_true", default=False)
    p.add_argument("--sort", action="store_true", default=False)
    p.add_argument("--prob_cf", type=float, default=0.5)
    p.add_argument("--gzip", action="store_true", default=False)
    p.add_argument("--device_agg", action="store_true", default=False,
                   help="run the per-block site sort + integer segment "
                        "sums on --device; output is byte-identical to "
                        "the host path")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="the device of --device_agg (default the card); "
                        "without --device_agg call_freq runs on the host")
    p.add_argument("--pod_shard_inputs", type=str, default="auto",
                   choices=["auto", "always", "never"],
                   help="pod mode (WORLD_SIZE > 1) only: shard the input "
                        "list over ranks (always: a shared filesystem), "
                        "keep each rank's own list (never: disjoint "
                        "per-rank inputs), or decide by comparing the "
                        "ranks' lists (auto)")
    p.set_defaults(func=main_call_freq)

    p = subparsers.add_parser("train", description="train a model")
    p.add_argument("--train_file", type=str, required=True,
                   help="features TSV (plain or .gz) with labels, or a v1 "
                        ".npz batch or directory of them")
    p.add_argument("--valid_file", type=str, required=True)
    p.add_argument("--model_dir", type=str, required=True)
    # auto = bf16 mixed precision on the card: float32 master parameters
    # and optimizer, bf16 products and storage, f32 gate math, cell
    # states and gradient accumulation in the kernels
    _add_model_args(p, dropout_default=0.5, compute_dtype_default="auto")
    _add_device_args(p)
    p.add_argument("--optim_type", type=str, default="Adam",
                   choices=["Adam", "RMSprop", "SGD", "Ranger"])
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr_decay", type=float, default=0.1)
    p.add_argument("--lr_decay_step", type=int, default=2)
    p.add_argument("--max_epoch_num", type=int, default=10)
    p.add_argument("--min_epoch_num", type=int, default=5)
    p.add_argument("--step_interval", type=int, default=100)
    p.add_argument("--pos_weight", type=float, default=1.0)
    p.add_argument("--init_model", type=str, default=None)
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the train state in --model_dir "
                        "(params + optimizer + epoch position), written "
                        "after every epoch by this package or by the JAX "
                        "package")
    p.add_argument("--stream", type=str, default="auto",
                   choices=["auto", "yes", "no"],
                   help="stream the training file in shuffled blocks "
                        "(bounded memory); auto streams files over 8GB")
    p.add_argument("--device_resident", type=str, default="auto",
                   choices=["auto", "never"],
                   help="auto: upload both datasets to the device once and "
                        "gather each step's rows there (each rank its row "
                        "block under a multi-process launch); datasets "
                        "over the budget (half the card's free memory, at "
                        "most DSP_RESIDENT_MAX_BYTES) train on the spill "
                        "plane, slab by slab. never: gather and upload "
                        "each step's rows on the host")
    p.add_argument("--tmpdir", type=str, default="/tmp",
                   help="accepted for JAX CLI compatibility (unused)")
    p.set_defaults(func=main_train)

    # ---- denoise ----
    p = subparsers.add_parser("denoise",
                              description="clean training samples by "
                                          "cross-rank")
    p.add_argument("--train_file", type=str, required=True)
    p.add_argument("--is_filter_fn", type=str, default="no")
    # the filter models are thrown away; only their averaged
    # probabilities against a coarse threshold count, so auto (bf16 on
    # the card) is the default here as everywhere
    _add_model_args(p, dropout_default=0.5,
                    model_type_default="signal_bilstm",
                    compute_dtype_default="auto")
    _add_device_args(p)
    p.add_argument("--pos_weight", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--epoch_num", type=int, default=3)
    p.add_argument("--step_interval", type=int, default=100)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--score_cf", type=float, default=0.5)
    p.add_argument("--kept_ratio", type=float, default=0.99)
    p.add_argument("--fst_iter_prob", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=None,
                   help="seed every random choice of the loop (half "
                        "splits, mini-training init, shuffles, k-mer-"
                        "balanced negative reselection) for a "
                        "reproducible denoise")
    p.add_argument("--device_resident", type=str, default="auto",
                   choices=["auto", "never"],
                   help="auto: a mini-training uploads both halves once "
                        "and gathers each step's rows on the device when "
                        "they fit half the card's free memory; never: "
                        "every step is gathered and uploaded on the host")
    p.set_defaults(func=main_denoise)

    # ---- tools ----
    from .tools import register_tools
    register_tools(subparsers)
    return parser


def run_device(args) -> str:
    """The device a parsed command runs on: ``--device``, except that
    call_freq uses it only with --device_agg and extract and the tools
    run on the host."""
    if args.func is main_call_freq and not args.device_agg:
        return "cpu"
    return getattr(args, "device", "cpu")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return 0
    from .parallel import dist
    from .utils.allocator import tune_host_allocator
    tune_host_allocator()
    started = dist.init_distributed(device=run_device(args))
    try:
        args.func(args)
    finally:
        if started:
            dist.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
