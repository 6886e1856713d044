"""Entry ``call_mods_fast5``: the fused fast5 path of ``call_mods
--input_path <fast5 dir>``. Set-up builds one ``CallModsEngine`` from
the benchmark's ``.ckpt``, as ``call_mods`` does; a pass is one
``extract_to_call_mods`` over the whole directory: the program's spawned
extraction workers read, decompress and extract the fast5s in batches,
and the engine calls the blocks they hand over, writing its rows through
its own writer. Each pass starts and shuts down its pool of workers, as
every ``call_mods`` call over a run folder does.

Options (a workload file's ``options``): ``call_mods`` flags by name,
given to the program's own CLI parser (``cli.build_parser``), so that
every flag not named keeps the CLI's default; ``reference_path`` is a
file name beside the input directory. What the program prints during a
pass, its workers' prints too, goes to standard error: standard output
is the benchmark's."""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

from deepsignal_plant_tpu_torch.cli import build_parser
from deepsignal_plant_tpu_torch.config import CallConfig
from deepsignal_plant_tpu_torch.pipeline.call_mods import CallModsEngine
from deepsignal_plant_tpu_torch.pipeline.extract import extract_to_call_mods

from portbench.entries.call_mods import model_config


@contextlib.contextmanager
def stdout_to_stderr():
    """File descriptor 1 on standard error, for this process and the
    processes it starts meanwhile."""
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


class Entry:
    def __init__(self, cfg: dict, options: dict, ckpt: str, device):
        self.model_cfg = model_config(cfg, device)
        self.options = options
        self.ckpt = ckpt
        args = self.args(".", os.devnull)
        call_cfg = CallConfig(
            device_batch=args.device_batch or CallConfig.device_batch,
            transfer_dtype=("float16" if args.transfer_dtype == "auto"
                            else args.transfer_dtype),
            packed_wire=args.packed_wire,
            num_parse_workers=args.parse_workers,
            device_resident=args.device_resident)
        self.engine = CallModsEngine(ckpt, self.model_cfg, call_cfg, [device])

    @property
    def compute_dtype(self) -> str:
        return self.model_cfg.compute_dtype

    def args(self, input_path: str, out_path: str):
        """The parsed ``call_mods`` command line of a pass."""
        argv = ["call_mods", "--input_path", input_path, "--model_path",
                self.ckpt, "--result_file", out_path]
        for name, value in self.options.items():
            if name == "reference_path":
                value = os.path.join(
                    os.path.dirname(os.path.abspath(input_path)), value)
            argv += [f"--{name}", str(value)]
        return build_parser().parse_args(argv)

    def run_pass(self, input_path: str, out_path: str) -> dict:
        """One pass; the engine's CallStats as a dict (``fast5_errors``:
        the files that failed to read or extract)."""
        args = self.args(input_path, out_path)
        with stdout_to_stderr():
            stats = extract_to_call_mods(self.engine, input_path, args,
                                         out_path)
        return dataclasses.asdict(stats)

    def checks(self, stats: dict) -> dict:
        """The window's own checks, ``stats`` the CallStats summed over
        its passes: ``fast5_failed``, the files that the program failed
        to read or extract, limit 0."""
        return {"fast5_failed": (stats.get("fast5_errors", 0), 0)}

    def close(self) -> None:
        self.engine = None


def build(cfg: dict, options: dict, ckpt: str, device) -> Entry:
    return Entry(cfg, options, ckpt, device)
