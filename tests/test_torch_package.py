"""Package rules of the port: it never imports JAX or the JAX package, it
runs on the card unless asked for the CPU, and chip_smoke.py fails
without a card or without the package beside it."""
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import deepsignal_plant_tpu_torch
from deepsignal_plant_tpu_torch.utils.device import (resolve_compute_dtype,
                                                     resolve_device)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        deepsignal_plant_tpu_torch.__path__, "deepsignal_plant_tpu_torch."))


def test_every_module_is_listed():
    mods = port_modules()
    for name in ("cli", "config", "ops.fused_lstm", "ops._build",
                 "ops.lstm", "ops.recurrence", "ops.optim", "io.dataset",
                 "models.bilstm", "models.convert", "pipeline.call_mods",
                 "pipeline.train", "utils.device", "utils.metrics",
                 "native", "utils.fastparse", "io.batching"):
        assert "deepsignal_plant_tpu_torch." + name in mods


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, importing every port module (and running
    its CLI's parser) leaves jax and deepsignal_plant_tpu out of
    sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import deepsignal_plant_tpu_torch.cli as c\n"
        "c.build_parser()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', "
        "'deepsignal_plant_tpu') or m.startswith(('jax.', "
        "'deepsignal_plant_tpu.')))\n"
        "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        src = fh.read()
    assert "import jax" not in src and "from jax" not in src
    assert "deepsignal_plant_tpu." not in src.replace(
        "deepsignal_plant_tpu_torch", "")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        for choice in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                resolve_device(choice)
    with pytest.raises(ValueError):
        resolve_device("tpu")


def test_resolve_compute_dtype():
    assert resolve_compute_dtype("auto", torch.device("cpu")) == "float32"
    assert resolve_compute_dtype("auto", torch.device("cuda")) == "bfloat16"
    assert resolve_compute_dtype("float32", torch.device("cuda")) == \
        "float32"


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo:
    the script exits non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
