"""The port's train state and ``--resume`` against the JAX package's,
on the CPU at a narrow width (hidden 32, 2 comb layers, batch 64,
dropout 0).

- Resume: JAX trains 2 epochs and writes its train state, then resumes
  to 4. The port resumes to 4 from JAX's state file, and also runs its
  own 2 + 2. As in JAX, a resumed run draws its epoch permutations from
  a fresh generator, so all three resumed runs agree with each other
  (the same validation accuracies, weights within 2e-5: the same
  float32 math in other summation orders), not with a run that never
  stopped.
- The port's container (npz arrays and a JSON header, no pickle)
  round-trips parameters and optimizer state bit for bit; a JAX state
  that names any global beyond numpy's arrays and optax's states is
  refused.

The streaming dataset's tests are in tests/test_torch_train_stream.py.
"""
import datetime
import os
import pickle
import re
import shutil

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
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import ModelConfig
from deepsignal_plant_tpu_torch.models import convert
from deepsignal_plant_tpu_torch.models.bilstm import ModelBiLSTM, init_params
from deepsignal_plant_tpu_torch.ops import optim
from deepsignal_plant_tpu_torch.pipeline import train as port_train

NARROW = dict(hidden_size=32, num_layers_comb=2, dropout_rate=0.0)
NARROW_FLAGS = ["--hid_rnn", "32", "--layernum1", "2", "--dropout_rate",
                "0", "--batch_size", "64"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs
    several test files at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def single_device_mesh(monkeypatch):
    real = jax_train.make_mesh
    monkeypatch.setattr(jax_train, "make_mesh",
                        lambda *a, **k: real(jax.devices()[:1]))


def flat(tree) -> dict:
    return convert._flatten(jax.tree_util.tree_map(np.asarray, tree))


def assert_trees_close(got, want, atol):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=k)


def accuracies(text: str) -> list[str]:
    return re.findall(r"Accuracy: ([0-9.]+)", text)


def write_rows(path, seed, n_reads, sites=24) -> str:
    rows = synth_feature_rows(np.random.default_rng(seed), n_reads, sites)
    return write_feature_file(str(path), rows)


# ---------------------------------------------------------------------------
# resume


@pytest.mark.parametrize("optim_type", ["SGD", "Adam"])
def test_resume_matches_jax(tmp_path, capsys, single_device_mesh,
                            optim_type):
    tr = write_rows(tmp_path / "train.tsv", 1, 8)       # 192 rows: 3 steps
    va = write_rows(tmp_path / "valid.tsv", 2, 4)
    jcfg = JaxModelConfig(**NARROW)
    init = str(tmp_path / "init.ckpt.npz")
    jax_convert.save_checkpoint(
        init, jax_bilstm.init_params(jax.random.PRNGKey(3), jcfg), jcfg)
    lr = "0.05" if optim_type == "SGD" else "0.005"
    common = dict(batch_size=64, lr=float(lr), min_epoch_num=4,
                  step_interval=2, optim_type=optim_type,
                  device_resident="never")
    jdir = str(tmp_path / "jax")
    os.makedirs(jdir)
    state = port_train.train_state_path(jdir, "both_bilstm")
    jax_train.train_loop(
        jcfg, JaxTrainConfig(max_epoch_num=2, **common),
        JaxDataset.from_file(tr), JaxDataset.from_file(va), jdir,
        init_model=init)
    assert state == jax_train.train_state_path(jdir, "both_bilstm")
    shutil.copy(state, tmp_path / "jax_epoch2.npz")
    capsys.readouterr()
    want = jax_train.train_loop(
        jcfg, JaxTrainConfig(max_epoch_num=4, **common),
        JaxDataset.from_file(tr), JaxDataset.from_file(va), jdir,
        init_model=init, resume=True)
    want_acc = accuracies(capsys.readouterr().out)

    def port(model_dir, epochs, *extra):
        args = cli.build_parser().parse_args([
            "train", "--train_file", tr, "--valid_file", va, "--model_dir",
            model_dir, "--device", "cpu", "--init_model", init, "--lr", lr,
            "--max_epoch_num", str(epochs), "--min_epoch_num", "4",
            "--step_interval", "2", "--optim_type", optim_type,
            "--device_resident", "never", *NARROW_FLAGS, *extra])
        res = port_train.train(args)
        return res, accuracies(capsys.readouterr().out)

    # the port from JAX's state file
    pdir = tmp_path / "port_from_jax"
    pdir.mkdir()
    shutil.copy(tmp_path / "jax_epoch2.npz",
                port_train.train_state_path(str(pdir), "both_bilstm"))
    from_jax, acc_from_jax = port(str(pdir), 4, "--resume")
    # the port's own 2 + 2; the second run keeps the first's checkpoints
    own = str(tmp_path / "port")
    first, _ = port(own, 2)
    kept = sorted(os.listdir(own))
    second, acc_own = port(own, 4, "--resume")
    assert set(kept) <= set(os.listdir(own))
    for res, acc in ((from_jax, acc_from_jax), (second, acc_own)):
        assert (res["start_epoch"], res["start_step"]) == (2, 6)
        assert res["steps"] == 12 and res["epochs_run"] == 4
        assert len(want_acc) == 4 and acc == want_acc
        assert res["best_accuracy"] == want["best_accuracy"]
        assert_trees_close(res["params"], want["params"], atol=2e-5)
    assert first["steps"] == 6 and first["start_epoch"] == 0


@pytest.mark.parametrize("optim_type", optim.OPTIM_TYPES)
def test_train_state_round_trips_bitwise(tmp_path, optim_type):
    """Three clipped updates, save, load into a fresh model and
    optimizer: every parameter, every state array and the count equal."""
    cfg = ModelConfig(**NARROW)
    model = ModelBiLSTM.from_params(init_params(cfg, 5), cfg, CPU,
                                    trainable=True)
    weights = list(model.parameters())
    sched = optim.step_decay_schedule(0.01, 2, 2, 0.1)
    opt = optim.Optimizer(optim_type, sched, weights)
    rng = np.random.default_rng(6)
    for _ in range(3):
        opt.step(port_train.clip_by_global_norm(
            [torch.from_numpy(rng.normal(size=w.shape).astype(np.float32))
             for w in weights], 0.5))
    path = port_train.train_state_path(str(tmp_path), "both_bilstm")
    port_train.save_train_state(path, model, opt, 3, 7, 0.625)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    with np.load(path, allow_pickle=False) as z:
        assert "header" in z.files and "train_state" not in z.files
    st = port_train.load_train_state(path)
    assert (st["epoch"], st["global_step"], st["best_accuracy"],
            st["optim_type"]) == (3, 7, 0.625, optim_type)
    model2 = ModelBiLSTM.from_params(st["params"], cfg, CPU, trainable=True)
    opt2 = optim.Optimizer(optim_type, sched, list(model2.parameters()))
    port_train.restore_optimizer(opt2, model2, st, path)
    for a, b in zip(weights, model2.parameters()):
        assert torch.equal(a, b)
    s1, s2 = opt.state_arrays(), opt2.state_arrays()
    assert s1.keys() == s2.keys() and int(s2["count"]) == 3
    for slot in optim.STATE_SLOTS[optim_type]:
        for a, b in zip(s1[slot], s2[slot]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="state"):
        wrong = "SGD" if optim_type != "SGD" else "Adam"
        port_train.restore_optimizer(
            optim.Optimizer(wrong, sched, list(model2.parameters())),
            model2, st, path)


@pytest.mark.parametrize("optim_type", optim.OPTIM_TYPES)
def test_jax_state_loads_into_the_port(tmp_path, optim_type):
    """JAX's save_train_state of an optax state after two updates: the
    port reads its parameters and maps every optax leaf to the
    optimizer slot of the same parameter."""
    from deepsignal_plant_tpu.ops import optim as jax_optim
    jcfg = JaxModelConfig(**NARROW)
    params = jax_bilstm.init_params(jax.random.PRNGKey(1), jcfg)
    tx = jax_optim.make_optimizer(optim_type,
                                  jax_optim.step_decay_schedule(0.01, 2, 2,
                                                                0.1))
    state = tx.init(params)
    rng = np.random.default_rng(2)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        params, state = jax_train._clip_and_update(tx, 0.5, params, state,
                                                   grads)
    path = str(tmp_path / "s.npz")
    jax_train.save_train_state(path, params, state, 2, 4, 0.5)
    st = port_train.load_train_state(path)
    assert (st["epoch"], st["global_step"], st["best_accuracy"],
            st["optim_type"], st["opt"]["count"]) == (2, 4, 0.5,
                                                      optim_type, 2)
    cfg = ModelConfig(**NARROW)
    model = ModelBiLSTM.from_params(st["params"], cfg, CPU, trainable=True)
    opt = optim.Optimizer(optim_type, optim.step_decay_schedule(
        0.01, 2, 2, 0.1), list(model.parameters()))
    port_train.restore_optimizer(opt, model, st, path)
    assert_trees_close(convert.params_to_numpy(model), params, atol=0)
    names = [k.replace(".", "/") for k, _ in model.named_parameters()]
    flat_state = jax.tree_util.tree_map(np.asarray, state)
    leaves = {"SGD": lambda s: {"trace": s[0].trace},
              "RMSprop": lambda s: {"nu": s[0].nu},
              "Adam": lambda s: {"mu": s[0].mu, "nu": s[0].nu},
              "Ranger": lambda s: {"mu": s[1][0].mu, "nu": s[1][0].nu,
                                   "slow": s[2].slow}}[optim_type](flat_state)
    got = opt.state_arrays()
    for slot, tree in leaves.items():
        want = convert._flatten(tree)
        for n, a in zip(names, got[slot]):
            np.testing.assert_array_equal(a, want[n], err_msg=f"{slot} {n}")


def test_jax_state_with_a_foreign_global_is_refused(tmp_path):
    blob = pickle.dumps({"params": {}, "opt_state": (),
                         "epoch": datetime.date(2020, 1, 1),
                         "global_step": 0, "best_accuracy": 0.0})
    path = str(tmp_path / "evil.npz")
    np.savez(path, train_state=np.frombuffer(blob, np.uint8))
    with pytest.raises(pickle.UnpicklingError, match="datetime.date"):
        port_train.load_train_state(path)
    np.savez(path, header=np.frombuffer(b'{"format": "x"}', np.uint8))
    with pytest.raises(ValueError, match="no train state"):
        port_train.load_train_state(path)
