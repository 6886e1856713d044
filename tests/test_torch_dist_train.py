"""The port's multi-rank training against the JAX package's, on the CPU:
two ranks over gloo (tests/torch_launch.py starts them as torchrun
would), a narrow model (hidden 32, 2 comb layers), global batch 64 (32
a rank), dropout 0, SGD, 2 epochs, one JAX checkpoint as the initial
parameters of both packages.

- The sharded-resident plane against JAX in this process with its mesh
  cut to 2 of the 8 virtual CPU devices (the same numbers as N hosts of
  one device each: docs/PARITY.md).
- The host-fed plane against a real 2-process ``jax.distributed`` run
  (CPU, gloo collectives), as tests/test_dist_2proc.py launches it.

321 training rows leave rank 1 one row short, so on both planes one of
its steps has no valid row; 75 validation rows take two evaluation
steps a rank. Step losses and final weights agree within 2e-5 (float32
sums of two ranks' terms in another order within each rank), the
validation accuracies and the best checkpoint are equal, and the two
ranks' weights are bitwise equal. Then ``--resume`` at 2 ranks with
rank 1's model_dir empty (the state reaches it by broadcast), and the
streaming dataset's refusal.
"""
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from make_synthetic import synth_feature_rows, write_feature_file
from torch_launch import REPO, cli, free_port, launch, train_rank

import deepsignal_plant_tpu.pipeline.train as jax_train
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.config import TrainConfig as JaxTrainConfig
from deepsignal_plant_tpu.io.dataset import FeatureDataset as JaxDataset
from deepsignal_plant_tpu.models import bilstm as jax_bilstm
from deepsignal_plant_tpu.models import convert as jax_convert
from deepsignal_plant_tpu_torch.config import ModelConfig, TrainConfig
from deepsignal_plant_tpu_torch.io.dataset import StreamingFeatureDataset
from deepsignal_plant_tpu_torch.io.dataset import FeatureDataset
from deepsignal_plant_tpu_torch.models import convert
from deepsignal_plant_tpu_torch.pipeline import train as port_train

NARROW = dict(hidden_size=32, num_layers_comb=2, dropout_rate=0.0)
COMMON = dict(batch_size=64, lr=0.1, max_epoch_num=2, min_epoch_num=2,
              step_interval=4, optim_type="SGD")
BASE_FLAGS = ["--device", "cpu", "--hid_rnn", "32", "--layernum1", "2",
              "--dropout_rate", "0", "--batch_size", "64", "--lr", "0.1",
              "--optim_type", "SGD", "--step_interval", "4"]
FLAGS = [*BASE_FLAGS, "--max_epoch_num", "2", "--min_epoch_num", "2"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    rng = np.random.default_rng(31)
    rows = synth_feature_rows(rng, 17, 24)
    tr = write_feature_file(str(d / "train.tsv"), rows[:321])
    va = write_feature_file(str(d / "valid.tsv"), rows[321:396])
    jcfg = JaxModelConfig(**NARROW)
    init = str(d / "init.ckpt.npz")
    jax_convert.save_checkpoint(
        init, jax_bilstm.init_params(jax.random.PRNGKey(4), jcfg), jcfg)
    return {"dir": d, "train": tr, "valid": va, "init": init}


def flat(tree) -> dict:
    return convert._flatten(jax.tree_util.tree_map(np.asarray, tree))


def run_port(data, tmp_path, *flags) -> list:
    """Two ranks of the port's train; per rank (result, params)."""
    outs = launch(train_rank(
        str(tmp_path / "rank{rank}.npz"), "--train_file", data["train"],
        "--valid_file", data["valid"], "--model_dir",
        str(tmp_path / "model{rank}"), "--init_model", data["init"], *FLAGS,
        *flags), 2)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r}:\n{out[-4000:]}"
    ranks = []
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            ranks.append((json.loads(z["result"].tobytes()),
                          {k[len("params/"):]: z[k] for k in z.files
                           if k.startswith("params/")}))
    return ranks


def check_against(ranks, want_losses, want_params, want_acc, want_best,
                  want_ckpt, plane):
    (res0, p0), (res1, p1) = ranks
    for r, (res, _) in enumerate(ranks):
        assert (res["plane"], res["rank"], res["world_size"],
                res["local_batch"], res["steps"]) == (plane, r, 2, 32, 12)
        assert res["valid_accuracies"] == want_acc
        assert res["best_accuracy"] == want_best
        np.testing.assert_allclose(res["step_losses"], want_losses,
                                   atol=2e-5, rtol=0)
    assert res0["train_rows"] == 2 * 161 and res1["train_rows"] == 2 * 160
    # only rank 0 writes checkpoints
    assert os.path.basename(res0["best_ckpt"]) == os.path.basename(want_ckpt)
    assert res1["best_ckpt"] is None
    want = flat(want_params)
    assert sorted(p0) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
        np.testing.assert_allclose(p0[k], want[k], atol=2e-5, rtol=0,
                                   err_msg=k)


def test_sharded_resident_matches_jax_on_two_devices(data, tmp_path,
                                                     monkeypatch, capsys):
    real_mesh = jax_train.make_mesh
    monkeypatch.setattr(jax_train, "make_mesh",
                        lambda *a, **k: real_mesh(jax.devices()[:2]))
    losses = []
    real_chunk = jax_train.make_train_chunk_sharded

    def spy_chunk(*a, **k):
        fn = real_chunk(*a, **k)

        def run(*args):
            out = fn(*args)
            losses.append(np.asarray(out[2]))
            return out
        return run

    monkeypatch.setattr(jax_train, "make_train_chunk_sharded", spy_chunk)
    os.makedirs(tmp_path / "jax")
    want = jax_train.train_loop(
        JaxModelConfig(**NARROW), JaxTrainConfig(**COMMON),
        JaxDataset.from_file(data["train"]),
        JaxDataset.from_file(data["valid"]), str(tmp_path / "jax"),
        init_model=data["init"])
    out = capsys.readouterr().out
    assert "sharded device-resident data plane" in out
    acc = [float(a) for a in re.findall(r"Accuracy: ([0-9.]+)", out)]
    assert len(acc) == 4

    ranks = run_port(data, tmp_path)
    got_acc = [float("%.4f" % a) for a in ranks[0][0]["valid_accuracies"]]
    assert got_acc == acc
    check_against(ranks, np.concatenate(losses), want["params"],
                  ranks[0][0]["valid_accuracies"], want["best_accuracy"],
                  want["best_ckpt"], "sharded")


_JAX_WORKER = '''
import os, sys, json
pid = int(sys.argv[1]); port = sys.argv[2]
data = json.loads(sys.argv[3]); out = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=2, process_id=pid)
assert jax.process_count() == 2
import numpy as np
import deepsignal_plant_tpu.pipeline.train as T
from deepsignal_plant_tpu.config import ModelConfig, TrainConfig
from deepsignal_plant_tpu.io.dataset import FeatureDataset
from deepsignal_plant_tpu.models.convert import _flatten

losses = []
real = T.make_train_step
def spy(*a, **k):
    fn = real(*a, **k)
    def run(*args):
        res = fn(*args)
        losses.append(float(np.asarray(res[2])))
        return res
    return run
T.make_train_step = spy
model_dir = out + "_jax%d" % pid
os.makedirs(model_dir, exist_ok=True)
res = T.train_loop(ModelConfig(**data["narrow"]),
                   TrainConfig(device_resident="never", **data["common"]),
                   FeatureDataset.from_file(data["train"]),
                   FeatureDataset.from_file(data["valid"]), model_dir,
                   init_model=data["init"])
if pid == 0:
    np.savez(out, losses=np.asarray(losses),
             best=np.asarray(res["best_accuracy"]),
             ckpt=np.frombuffer(os.path.basename(res["best_ckpt"]).encode(),
                                np.uint8),
             **{"params/" + k: np.asarray(v)
                for k, v in _flatten(jax.device_get(res["params"])).items()})
'''


def test_host_fed_matches_a_two_process_jax_run(data, tmp_path):
    worker = tmp_path / "jax_worker.py"
    worker.write_text(_JAX_WORKER)
    spec = json.dumps({"narrow": NARROW, "common": COMMON,
                       "train": data["train"], "valid": data["valid"],
                       "init": data["init"]})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="")
    port = str(free_port())
    out = str(tmp_path / "jax.npz")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), port, spec, out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"JAX pid {i}:\n{log[-4000:]}"
    acc = [float(a) for a in re.findall(r"Accuracy: ([0-9.]+)", logs[0])]
    assert len(acc) == 4
    with np.load(out) as z:
        want_losses, want_best = z["losses"], float(z["best"])
        want_ckpt = z["ckpt"].tobytes().decode()
        want_params = {k[len("params/"):]: z[k] for k in z.files
                       if k.startswith("params/")}

    ranks = run_port(data, tmp_path, "--device_resident", "never")
    assert [float("%.4f" % a)
            for a in ranks[0][0]["valid_accuracies"]] == acc
    check_against(ranks, want_losses, convert._unflatten(want_params),
                  ranks[0][0]["valid_accuracies"], want_best, want_ckpt,
                  "host-fed")


def test_resume_reaches_rank1_by_broadcast(data, tmp_path):
    """One epoch at 2 ranks, then --resume to 2 with each rank's own
    model_dir: rank 1's holds nothing (only rank 0 writes), so its
    epoch, step, parameters and optimizer state come from rank 0's
    broadcast; the ranks end bitwise equal."""
    flags = ["--train_file", data["train"], "--valid_file", data["valid"],
             "--model_dir", str(tmp_path / "model{rank}"),
             *BASE_FLAGS, "--min_epoch_num", "1", "--verbose_stages"]
    first = launch(cli("train", *flags, "--max_epoch_num", "1"), 2)
    for rc, out in first:
        assert rc == 0, out[-4000:]
    assert os.listdir(tmp_path / "model1") == []
    assert "both_bilstm.train_state.npz" in os.listdir(tmp_path / "model0")
    outs = launch(train_rank(
        str(tmp_path / "resumed{rank}.npz"), *flags, "--max_epoch_num", "2",
        "--resume"), 2)
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    res, params = [], []
    for r in range(2):
        with np.load(tmp_path / f"resumed{r}.npz") as z:
            res.append(json.loads(z["result"].tobytes()))
            params.append({k: z[k] for k in z.files
                           if k.startswith("params/")})
    for r in range(2):
        assert (res[r]["start_epoch"], res[r]["start_step"],
                res[r]["steps"], res[r]["epochs_run"]) == (1, 6, 12, 2)
    assert res[0]["step_losses"] == res[1]["step_losses"]
    for k in params[0]:
        np.testing.assert_array_equal(params[0][k], params[1][k], err_msg=k)
    assert os.listdir(tmp_path / "model1") == []


def test_streaming_dataset_is_refused_under_a_launch(data, monkeypatch):
    monkeypatch.setattr(port_train, "process_info", lambda: (1, 2))
    with pytest.raises(ValueError, match="single-host only"):
        port_train.train_loop(
            ModelConfig(**NARROW), TrainConfig(**COMMON),
            StreamingFeatureDataset(data["train"]),
            FeatureDataset.from_file(data["valid"]), None,
            port_train.torch.device("cpu"), verbose=False)
