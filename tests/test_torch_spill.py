"""The port's spill plane against the JAX package's, on the CPU at a
narrow width (hidden 32, 2 comb layers, batch 64, dropout 0, SGD).

Both packages train 2 epochs from one JAX checkpoint on 360 training
rows with their resident budgets lowered (the JAX module's
``RESIDENT_MAX_BYTES`` on a one-device mesh, the port's
``DSP_RESIDENT_MAX_BYTES``) so that the rows go up in 3 slabs, the last
one ragged, on the float16 and the int8 wire (``DSP_TRAIN_SPILL_WIRE``).
They take the same slabs, evaluate after the same steps (the chunked
cadence, not every ``step_interval`` steps), reach the same validation
accuracies and the same best checkpoint's epoch, and end with weights
and step losses within 2e-5 (the same float32 math in other summation
orders; the wires round the features alike, so the spill runs are held
to each other, not to the resident plane).
"""
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from make_synthetic import synth_feature_rows, write_feature_file

import deepsignal_plant_tpu.pipeline.train as jax_train
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.config import TrainConfig as JaxTrainConfig
from deepsignal_plant_tpu.io.dataset import FeatureDataset as JaxDataset
from deepsignal_plant_tpu.models import bilstm as jax_bilstm
from deepsignal_plant_tpu.models import convert as jax_convert
from deepsignal_plant_tpu_torch.config import ModelConfig, TrainConfig
from deepsignal_plant_tpu_torch.io.dataset import FeatureDataset
from deepsignal_plant_tpu_torch.models import convert
from deepsignal_plant_tpu_torch.pipeline import train as port_train
from torch_jaxnative import jax_native_lib

# the JAX package's library (its spill plane's int8 wire quantizes with
# it), loaded in every worker before any test runs (tests/torch_jaxnative.py)
jax_native_lib()

NARROW = dict(hidden_size=32, num_layers_comb=2, dropout_rate=0.0)
CPU = torch.device("cpu")
COMMON = dict(batch_size=64, lr=0.05, max_epoch_num=2, min_epoch_num=2,
              step_interval=3, optim_type="SGD")
#: budgets that cut 360 rows into slabs of 128 (3 slabs, the last of
#: 104 rows) beside a 40-row validation set: (budget - 2 * valid) // 3
#: bytes a slab, 508 bytes a row on the float16 wire and 274 on int8
BUDGET = {"float16": 2 * 41760 + 3 * 70000, "int8": 2 * 41760 + 3 * 36000}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("spill")
    rng = np.random.default_rng(21)
    rows = synth_feature_rows(rng, 17, 24)
    tr = write_feature_file(str(d / "train.tsv"), rows[:360])
    va = write_feature_file(str(d / "valid.tsv"), rows[360:400])
    jcfg = JaxModelConfig(**NARROW)
    init = str(d / "init.ckpt.npz")
    jax_convert.save_checkpoint(
        init, jax_bilstm.init_params(jax.random.PRNGKey(5), jcfg), jcfg)
    return {"train": tr, "valid": va, "init": init}


def flat(tree) -> dict:
    return convert._flatten(jax.tree_util.tree_map(np.asarray, tree))


def jax_spill_run(data, wire, model_dir, monkeypatch, capsys):
    """JAX's train_loop on a one-device mesh with its budget lowered;
    its per-chunk losses caught as they leave the chunk."""
    real_mesh = jax_train.make_mesh
    monkeypatch.setattr(jax_train, "make_mesh",
                        lambda *a, **k: real_mesh(jax.devices()[:1]))
    monkeypatch.setattr(jax_train, "RESIDENT_MAX_BYTES", BUDGET[wire])
    losses = []
    real_chunk = jax_train.make_train_chunk

    def spy_chunk(*a, **k):
        fn = real_chunk(*a, **k)

        def run(*args):
            out = fn(*args)
            losses.append(np.asarray(out[2]))
            return out
        return run

    monkeypatch.setattr(jax_train, "make_train_chunk", spy_chunk)
    os.makedirs(model_dir)
    res = jax_train.train_loop(
        JaxModelConfig(**NARROW), JaxTrainConfig(**COMMON),
        JaxDataset.from_file(data["train"]),
        JaxDataset.from_file(data["valid"]), model_dir,
        init_model=data["init"])
    out = capsys.readouterr().out
    return res, np.concatenate(losses), out


@pytest.mark.parametrize("wire", ["float16", "int8"])
def test_spill_matches_jax_spill_plane(data, wire, tmp_path, monkeypatch,
                                       capsys):
    monkeypatch.setenv("DSP_TRAIN_SPILL_WIRE", wire)
    want, want_losses, jout = jax_spill_run(
        data, wire, str(tmp_path / "jax"), monkeypatch, capsys)
    slabs = re.search(r"in (\d+) slab\(s\) of <= (\d+) rows", jout)
    assert slabs and (int(slabs[1]), int(slabs[2])) == (3, 128), jout

    monkeypatch.setenv("DSP_RESIDENT_MAX_BYTES", str(BUDGET[wire]))
    os.makedirs(tmp_path / "port")
    got = port_train.train_loop(
        ModelConfig(**NARROW), TrainConfig(**COMMON),
        FeatureDataset.from_file(data["train"]),
        FeatureDataset.from_file(data["valid"]), str(tmp_path / "port"),
        CPU, init_model=data["init"])
    pout = capsys.readouterr().out
    assert got["plane"] == "spill"
    assert got["spill"]["slabs"] == 3 and got["spill"]["slab_rows"] == 128
    assert got["spill"]["wire"] == wire
    # the same evaluation steps and accuracies, in the same order
    steps = re.compile(r"Step \[(\d+)/6\].*Accuracy: ([0-9.]+)")
    assert steps.findall(pout) == steps.findall(jout)
    assert len(steps.findall(pout)) >= 4
    assert got["best_accuracy"] == want["best_accuracy"]
    assert os.path.basename(got["best_ckpt"]) == \
        os.path.basename(want["best_ckpt"])
    assert got["steps"] == 12 and len(want_losses) == 12
    np.testing.assert_allclose(got["step_losses"], want_losses, atol=2e-5,
                               rtol=0)
    gp, wp = flat(got["params"]), flat(want["params"])
    assert sorted(gp) == sorted(wp)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], atol=2e-5, rtol=0,
                                   err_msg=k)


def test_budget_rule(data, monkeypatch):
    """The budget is DSP_RESIDENT_MAX_BYTES where set (the CPU has no
    free-memory query, so no cap otherwise); the planes follow JAX's
    order: resident when both sets fit, spill when the validation set
    fits a quarter of the budget, host-fed otherwise and under never; a
    multi-rank run keeps its share resident (sharded) or goes
    host-fed."""
    tr = FeatureDataset.from_file(data["train"])
    va = FeatureDataset.from_file(data["valid"])
    monkeypatch.delenv("DSP_RESIDENT_MAX_BYTES", raising=False)
    assert port_train.resident_budget(CPU) == sys.maxsize
    auto, never = TrainConfig(), TrainConfig(device_resident="never")

    def plane(budget, cfg=auto, world=1):
        monkeypatch.setenv("DSP_RESIDENT_MAX_BYTES", str(budget))
        assert port_train.resident_budget(CPU) == budget
        return port_train.pick_plane(cfg, tr, va, CPU, world)

    total, v = tr.nbytes + va.nbytes, va.nbytes
    assert plane(total) == "resident"
    assert plane(total, never) == "host-fed"
    assert plane(total - 1) == "spill"
    assert plane(4 * v) == "spill"
    assert plane(4 * v - 1) == "host-fed"
    assert plane(total // 2, world=2) == "sharded"
    assert plane(total // 2 - 1, world=2) == "host-fed"


def test_valid_set_over_a_quarter_of_the_budget_trains_host_fed(
        data, tmp_path, monkeypatch):
    """valid_bytes * 4 > budget: the host-fed plane, with the host-fed
    plane's weights."""
    va = FeatureDataset.from_file(data["valid"])
    cfg, tcfg = ModelConfig(**NARROW), TrainConfig(
        **{**COMMON, "max_epoch_num": 1, "min_epoch_num": 1})
    monkeypatch.setenv("DSP_RESIDENT_MAX_BYTES", str(4 * va.nbytes - 1))
    got = port_train.train_loop(cfg, tcfg,
                                FeatureDataset.from_file(data["train"]), va,
                                None, CPU, init_model=data["init"],
                                verbose=False)
    monkeypatch.delenv("DSP_RESIDENT_MAX_BYTES")
    want = port_train.train_loop(
        cfg, TrainConfig(**{**COMMON, "max_epoch_num": 1, "min_epoch_num": 1,
                            "device_resident": "never"}),
        FeatureDataset.from_file(data["train"]), va, None, CPU,
        init_model=data["init"], verbose=False)
    assert got["plane"] == want["plane"] == "host-fed"
    assert got["step_losses"] == want["step_losses"]
    gp, wp = flat(got["params"]), flat(want["params"])
    for k in wp:
        np.testing.assert_array_equal(gp[k], wp[k], err_msg=k)


def test_unknown_spill_wire_is_refused(data, monkeypatch):
    monkeypatch.setenv("DSP_TRAIN_SPILL_WIRE", "bfloat16")
    monkeypatch.setenv("DSP_RESIDENT_MAX_BYTES", str(BUDGET["float16"]))
    with pytest.raises(ValueError, match="DSP_TRAIN_SPILL_WIRE"):
        port_train.train_loop(
            ModelConfig(**NARROW), TrainConfig(**COMMON),
            FeatureDataset.from_file(data["train"]),
            FeatureDataset.from_file(data["valid"]), None, CPU,
            verbose=False)
