"""deepsignal_plant_tpu_torch CLI (counterpart of
deepsignal_plant_tpu/cli.py:20-60, :187-239 and :314-352).

Ported so far: ``call_mods`` and ``train`` on features TSVs. They take
the JAX package's flags with their defaults, plus ``--device`` and
``--verbose_stages``. Flags of planes that are not ported yet fail with
a clear error when set away from their default
(pipeline/call_mods.py::_refuse_unported,
pipeline/train.py::_refuse_unported).
"""
from __future__ import annotations

import argparse
import sys

from ._version import DEEPSIGNAL_PLANT_TPU_TORCH_VERSION


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
                   choices=["even", "compat"])


def main_call_mods(args):
    from .pipeline.call_mods import call_mods
    display_args(args)
    call_mods(args)


def main_train(args):
    from .pipeline.train import train
    display_args(args)
    train(args)


def _add_device_args(p):
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU with the "
                        "plain PyTorch versions of the kernels")
    p.add_argument("--verbose_stages", action="store_true", default=False,
                   help="print a JSON line of run counters at the end: "
                        "kernel launches, steps or tiles, stage seconds")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deepsignal_plant_tpu_torch",
        description="deepsignal_plant_tpu_torch detects 5mC from nanopore "
                    "reads of plants on an NVIDIA GPU:\n"
                    "\tcall_mods: call modifications\n"
                    "\ttrain: train a model",
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("-v", "--version", action="version",
                        version="deepsignal_plant_tpu_torch version: {}".format(
                            DEEPSIGNAL_PLANT_TPU_TORCH_VERSION))
    subparsers = parser.add_subparsers(title="modules")

    p = subparsers.add_parser("call_mods", description="call modifications")
    p.add_argument("--input_path", "-i", type=str, required=True,
                   help="features TSV (plain or .gz) from extract")
    p.add_argument("--f5_batch_size", type=int, default=30,
                   help="fast5 inputs only (not yet ported)")
    p.add_argument("--model_path", "-m", type=str, required=True,
                   help=".ckpt (torch) or .ckpt.npz (native) checkpoint")
    _add_model_args(p, dropout_default=0.0, compute_dtype_default="auto")
    _add_device_args(p)
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
                        "exact-parity runs; int8 is not yet ported")
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
                   help="always (one upload per segment) is not yet ported")
    p.add_argument("--result_file", "-o", type=str, required=True)
    p.add_argument("--gzip", action="store_true", default=False)
    _add_f5_args(p)
    p.add_argument("--nproc", "-p", type=int, default=4,
                   help="fast5 inputs only (not yet ported)")
    p.add_argument("--nproc_gpu", type=int, default=2,
                   help="accepted for reference CLI compatibility (unused)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="device trace directory (not yet ported)")
    p.set_defaults(func=main_call_mods)

    p = subparsers.add_parser("train", description="train a model")
    p.add_argument("--train_file", type=str, required=True,
                   help="features TSV (plain or .gz) with labels")
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
                   help="resume from a saved train state: not yet ported")
    p.add_argument("--stream", type=str, default="auto",
                   choices=["auto", "yes", "no"],
                   help="the streaming (block-shuffled) dataset is not yet "
                        "ported: yes fails, and so does auto on a file "
                        "over 8GB")
    p.add_argument("--device_resident", type=str, default="auto",
                   choices=["auto", "never"],
                   help="auto: upload both datasets to the device once and "
                        "gather each step's rows there; a dataset over the "
                        "budget (half the card's free memory) fails, as "
                        "the spill plane is not yet ported. never: gather "
                        "and upload each step's rows on the host")
    p.add_argument("--tmpdir", type=str, default="/tmp",
                   help="accepted for JAX CLI compatibility (unused)")
    p.set_defaults(func=main_train)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if hasattr(args, "func"):
        args.func(args)
    else:
        parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
