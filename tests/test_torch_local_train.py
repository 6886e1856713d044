"""train over several devices of one process (pipeline/train.py's
``Replica``, ``train_step`` and ``Replicated`` planes; the JAX
package's one process over a mesh of N local devices), on the CPU.

- ``train_loop`` over ``[cpu] * N`` (N = 2, 3) against JAX's
  ``train_loop`` with ``make_mesh`` cut to N of the 8 virtual CPU
  devices, narrow model (hidden 32, 2 comb layers), dropout 0, float32,
  SGD at lr 0.1 (Adam's normalised steps, or a larger rate, carry
  float32 rounding of the sums to 1e-4 in a few elements within 12
  steps): on the sharded-resident plane, the host-fed plane (340 training
  rows: the last step's global batch of 64 or 66 rows holds 20 or 10, so
  the last device's share is all padding; 75 validation rows leave the
  same in the evaluation's tail; two epochs) and the streamed plane (one
  epoch each on these two). Step losses and
  weights within 2e-5 (float32 sums of N devices' terms in other
  orders; the weights move over 1e-2), the validation accuracies, best
  accuracy and step and row counts equal, every replica's weights
  bitwise replica 0's.
- The replicas' parameters are bitwise equal after every step (dropout
  0.5, so each replica's gradients differ), ``[cpu]`` alone gives the
  bytes of ``cpu`` and of a one-card step without replica sums, and
  two local replicas at dropout 0.5 end bitwise where two gloo ranks end
  (tests/torch_launch.py; on the host-fed plane the ranks in the
  replicas' layout), so replica j draws rank j's masks.
- ``--resume`` across 1 and 2 devices: a state written over 2 devices
  resumes on 1, one written on 1 resumes over 2, within 2e-5 of each
  other (the host-fed plane gives both the same rows a step).
- ``resolve_devices`` is what ``train`` and ``denoise`` take their
  devices from (torch.cuda monkeypatched).
- ``tune_host_allocator`` (utils/allocator.py): two ``mallopt`` calls
  once a process, False off glibc, called by ``native.load()``.
"""
import json
import re

import jax
import numpy as np
import pytest
import torch

from make_synthetic import synth_feature_rows, write_feature_file
from torch_launch import launch, rank_runs

import deepsignal_plant_tpu.pipeline.train as jax_train
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.config import TrainConfig as JaxTrainConfig
from deepsignal_plant_tpu.io.dataset import FeatureDataset as JaxDataset
from deepsignal_plant_tpu.io.dataset import \
    StreamingFeatureDataset as JaxStreaming
from deepsignal_plant_tpu.models import bilstm as jax_bilstm
from deepsignal_plant_tpu.models import convert as jax_convert
from deepsignal_plant_tpu_torch import cli, native
from deepsignal_plant_tpu_torch.config import ModelConfig, TrainConfig
from deepsignal_plant_tpu_torch.io.dataset import (FeatureDataset,
                                                   StreamingFeatureDataset)
from deepsignal_plant_tpu_torch.models import convert
from deepsignal_plant_tpu_torch.pipeline import denoise as port_denoise
from deepsignal_plant_tpu_torch.pipeline import train as port_train
from deepsignal_plant_tpu_torch.utils import allocator

CPU = torch.device("cpu")
NARROW = dict(hidden_size=32, num_layers_comb=2, dropout_rate=0.0)
COMMON = dict(batch_size=64, lr=0.1, max_epoch_num=2, min_epoch_num=2,
              step_interval=4, optim_type="SGD")
FLAGS = ["--device", "cpu", "--hid_rnn", "32", "--layernum1", "2",
         "--batch_size", "64", "--lr", "0.1", "--optim_type", "SGD",
         "--step_interval", "4", "--max_epoch_num", "2", "--min_epoch_num",
         "2"]
#: plane -> JAX's device_resident
PLANES = {"sharded": "auto", "host-fed": "never", "stream": "auto"}
#: plane -> epochs of the comparisons with JAX: two where each epoch
#: draws a global permutation and ends in all-padding shares
EPOCHS = {"sharded": 1, "host-fed": 2, "stream": 1}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: tiny tensors, several test files at once on
    the same cores, and bitwise comparisons with one-thread ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("local_train")
    rows = synth_feature_rows(np.random.default_rng(31), 18, 24)
    tr = write_feature_file(str(d / "train.tsv"), rows[:340])
    va = write_feature_file(str(d / "valid.tsv"), rows[340:415])
    jcfg = JaxModelConfig(**NARROW)
    init = str(d / "init.ckpt.npz")
    jax_convert.save_checkpoint(
        init, jax_bilstm.init_params(jax.random.PRNGKey(4), jcfg), jcfg)
    return {"dir": d, "train": tr, "valid": va, "init": init}


def flat(tree) -> dict:
    return convert._flatten(jax.tree_util.tree_map(np.asarray, tree))


def port_datasets(data, plane: str):
    train_ds = (StreamingFeatureDataset(data["train"], block_rows=100)
                if plane == "stream" else
                FeatureDataset.from_file(data["train"]))
    return train_ds, FeatureDataset.from_file(data["valid"])


def port_run(data, devices, plane="host-fed", model_dir=None, **kw):
    cfg = dict(COMMON, **kw.pop("train", {}))
    return port_train.train_loop(
        ModelConfig(**{**NARROW, **kw.pop("model", {})}),
        TrainConfig(device_resident=PLANES[plane], **cfg),
        *port_datasets(data, plane), model_dir, devices,
        init_model=data["init"], verbose=False, **kw)


def assert_replicas_equal(res) -> None:
    want = flat(res["params"])
    for other in res["replica_params"]:
        got = flat(other)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_n_devices_match_jax_on_n_devices(data, monkeypatch, capsys, n,
                                          plane):
    real_mesh = jax_train.make_mesh
    monkeypatch.setattr(jax_train, "make_mesh",
                        lambda *a, **k: real_mesh(jax.devices()[:n]))
    losses = []

    def spy(name, at):
        real = getattr(jax_train, name)

        def make(*a, **k):
            fn = real(*a, **k)

            def run(*args):
                out = fn(*args)
                losses.append(np.asarray(out[at]).reshape(-1))
                return out
            return run
        monkeypatch.setattr(jax_train, name, make)

    spy("make_train_chunk_sharded", 2)
    spy("make_train_step", 2)
    train_ds = (JaxStreaming(data["train"], block_rows=100)
                if plane == "stream" else JaxDataset.from_file(data["train"]))
    epochs = {"max_epoch_num": EPOCHS[plane], "min_epoch_num": EPOCHS[plane]}
    want = jax_train.train_loop(
        JaxModelConfig(**NARROW),
        JaxTrainConfig(device_resident=PLANES[plane], **{**COMMON, **epochs}),
        train_ds, JaxDataset.from_file(data["valid"]), None,
        init_model=data["init"])
    out = capsys.readouterr().out
    assert ("sharded device-resident data plane" in out) == (
        plane == "sharded")
    want_acc = re.findall(r"Accuracy: ([0-9.]+)", out)
    assert len(want_acc) == 2 * EPOCHS[plane]

    got = port_run(data, [CPU] * n, plane, train=epochs)
    B = -(-64 // n)
    steps = -(-340 // (n * B))
    assert (got["plane"], got["local_batch"], got["steps"],
            got["world_size"], got["devices"]) == (
        plane, B, EPOCHS[plane] * steps, 1, ["cpu"] * n)
    assert got["train_rows"] == EPOCHS[plane] * 340
    assert ["%.4f" % a for a in got["valid_accuracies"]] == want_acc
    assert got["best_accuracy"] == want["best_accuracy"]
    np.testing.assert_allclose(got["step_losses"], np.concatenate(losses),
                               atol=2e-5, rtol=0)
    want_p, got_p = flat(want["params"]), flat(got["params"])
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], atol=2e-5, rtol=0,
                                   err_msg=k)
    # the weights moved a thousand times the tolerance from where both
    # started
    init = flat(convert.load_any_checkpoint(data["init"],
                                            ModelConfig(**NARROW)))
    assert max(np.abs(got_p[k] - init[k]).max() for k in init) > 1e-2
    assert len(got["replica_params"]) == n - 1
    assert_replicas_equal(got)


@pytest.mark.parametrize("plane", ["sharded", "host-fed"])
def test_replicas_are_bitwise_equal_after_every_step(data, monkeypatch,
                                                     plane):
    """At dropout 0.5 each replica draws its own masks and its own
    gradients; after the sums every replica holds the same bytes."""
    real = port_train.train_step
    checked = []

    def spy(reps, parts, clip, gens):
        loss = real(reps, parts, clip, gens)
        assert len({id(g) for g in gens}) == len(reps)
        for r in reps[1:]:
            assert r.model is not reps[0].model
            for w, w0 in zip(r.weights, reps[0].weights):
                assert w.data_ptr() != w0.data_ptr()
                assert torch.equal(w, w0)
        checked.append(loss)
        return loss

    monkeypatch.setattr(port_train, "train_step", spy)
    res = port_run(data, [CPU] * 3, plane, model={"dropout_rate": 0.5},
                   train={"max_epoch_num": 1, "min_epoch_num": 1})
    assert len(checked) == res["steps"] == 6
    assert_replicas_equal(res)


def one_card_step(calls: list):
    """The one-card step with no sum over replicas or ranks: the training
    forward, the weighted CE over the rows kept, its gradients, the clip
    and the optimizer step."""
    def step(reps, parts, clip, gens):
        (r,), ((batch, labels, mask),), (gen,) = reps, parts, gens
        logits, _ = r.model(batch, train=True, generator=gen)
        num, den = port_train.masked_ce_terms(logits, labels,
                                              r.class_weights, mask)
        loss = num / torch.clamp(den, min=1e-12)
        grads = torch.autograd.grad(loss, r.weights)
        r.opt.step(port_train.clip_by_global_norm(grads, clip))
        calls.append(1)
        return loss.detach()
    return step


def test_one_device_is_the_one_card_loop(data, monkeypatch):
    """``[cpu]`` gives the bytes of ``cpu`` through ``train_step`` and of
    the one-card step without replica sums, on both planes, at dropout
    0.5."""
    calls = []
    for plane in ("sharded", "host-fed"):
        one = port_run(data, CPU, plane, model={"dropout_rate": 0.5})
        with monkeypatch.context() as m:
            m.setattr(port_train, "train_step", one_card_step(calls))
            listed = port_run(data, [CPU], plane,
                              model={"dropout_rate": 0.5})
        assert one["plane"] == listed["plane"] == (
            "resident" if plane == "sharded" else "host-fed")
        assert one["replica_params"] == listed["replica_params"] == []
        assert one["step_losses"] == listed["step_losses"]
        assert one["valid_accuracies"] == listed["valid_accuracies"]
        a, b = flat(one["params"]), flat(listed["params"])
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(calls) == 2 * 12


@pytest.fixture(scope="module")
def two_ranks(data, tmp_path_factory):
    """Two gloo ranks (tests/torch_launch.py) training on each plane at
    dropout 0.5, in one launch; per plane rank 0's result and
    parameters. On the host-fed plane the ranks take the replicas'
    global-batch layout (torch_launch's ``host_fed_layout``)."""
    d = tmp_path_factory.mktemp("two_ranks")
    runs = []
    for plane in ("sharded", "host-fed"):
        runs.append([str(d / f"{plane}_rank{{rank}}.npz"), [
            "train", "--train_file", data["train"], "--valid_file",
            data["valid"], "--init_model", data["init"], *FLAGS,
            "--dropout_rate", "0.5", "--device_resident", PLANES[plane],
            "--model_dir", str(d / f"{plane}_m{{rank}}")],
            {"host_fed_layout": "global"}])
    outs = launch(rank_runs(runs), 2)
    for r, (rc, text) in enumerate(outs):
        assert rc == 0, f"rank {r}:\n{text[-4000:]}"
    out = {}
    for plane in ("sharded", "host-fed"):
        with np.load(d / f"{plane}_rank0.npz") as z:
            out[plane] = (json.loads(z["result"].tobytes()),
                          {k[len("params/"):]: z[k] for k in z.files
                           if k.startswith("params/")})
    return out


@pytest.mark.parametrize("plane", ["sharded", "host-fed"])
def test_two_replicas_end_where_two_ranks_end(data, two_ranks, plane):
    """At dropout 0.5: replica j draws the dropout masks rank j draws, and
    the sums of two are the same float32 adds, so two local replicas end
    bitwise where two gloo ranks end."""
    ranks, want = two_ranks[plane]
    got = port_run(data, [CPU] * 2, plane, model={"dropout_rate": 0.5})
    assert ranks["plane"] == got["plane"] == plane
    assert got["step_losses"] == ranks["step_losses"]
    assert got["valid_accuracies"] == ranks["valid_accuracies"]
    got_p = flat(got["params"])
    assert sorted(got_p) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got_p[k], want[k], err_msg=k)


def test_resume_across_one_and_two_devices(data, tmp_path):
    """One epoch over 2 devices resumed on 1, and one epoch on 1 resumed
    over 2 (host-fed: a step takes the same rows on both): each resumed
    run starts at epoch 1, step 6, the two end within 2e-5 of each
    other, and the replicas of the 2-device run are bitwise equal."""
    one_epoch = {"max_epoch_num": 1, "min_epoch_num": 1}
    results = {}
    for first, then in ((2, 1), (1, 2)):
        d = tmp_path / f"from{first}"
        d.mkdir()
        port_run(data, [CPU] * first, model_dir=str(d), train=one_epoch)
        assert "both_bilstm.train_state.npz" in {p.name for p in d.iterdir()}
        res = port_run(data, [CPU] * then, model_dir=str(d), resume=True)
        assert (res["start_epoch"], res["start_step"], res["epochs_run"],
                res["steps"]) == (1, 6, 2, 12)
        assert len(res["replica_params"]) == then - 1
        assert_replicas_equal(res)
        results[first] = res
    a, b = results[2], results[1]
    np.testing.assert_allclose(a["step_losses"], b["step_losses"],
                               atol=2e-5, rtol=0)
    pa, pb = flat(a["params"]), flat(b["params"])
    for k in pa:
        np.testing.assert_allclose(pa[k], pb[k], atol=2e-5, rtol=0,
                                   err_msg=k)


@pytest.fixture()
def three_cards(monkeypatch):
    """torch.cuda as a machine with three cards would answer it."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)


class Taken(Exception):
    """Stops an entry point once it has taken its devices."""


@pytest.mark.parametrize("command", ["train", "denoise"])
@pytest.mark.parametrize("choice,launched,want", [
    (None, False, ["cuda:0", "cuda:1", "cuda:2"]),
    ("cuda", False, ["cuda:0", "cuda:1", "cuda:2"]),
    ("cuda:2", False, ["cuda:2"]),
    ("cpu", False, ["cpu"]),
    (None, True, ["cuda:1"])])
def test_entry_points_take_resolve_devices(data, three_cards, monkeypatch,
                                           command, choice, launched, want):
    """No --device or --device cuda: every visible card; under a launch
    the rank's card; cuda:<n> that card; cpu the CPU."""
    if launched:
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("LOCAL_RANK", "1")
        # the group is not started: rank 0's view of it
        for mod in (port_train, port_denoise):
            monkeypatch.setattr(mod, "process_info", lambda: (0, 2))
    taken = []

    def take(devices):
        taken.append([str(d) for d in devices])
        raise Taken

    if command == "train":
        monkeypatch.setattr(port_train, "train_loop",
                            lambda *a, **k: take(a[5]))
        argv = ["train", "--train_file", data["train"], "--valid_file",
                data["valid"], "--model_dir", str(data["dir"] / "m")]
    else:
        monkeypatch.setattr(port_denoise, "CrossRankTrainer",
                            lambda cfg, tcfg, devices: take(devices))
        monkeypatch.setattr(port_denoise, "filter_rows_by_label",
                            lambda *a: None)
        argv = ["denoise", "--train_file", data["train"]]
    if choice is not None:
        argv += ["--device", choice]
    args = cli.build_parser().parse_args(argv)
    with pytest.raises(Taken):
        args.func(args)
    assert taken == [want]


def test_a_launch_refuses_several_local_devices(data, monkeypatch):
    monkeypatch.setattr(port_train, "process_info", lambda: (0, 2))
    with pytest.raises(ValueError, match="one card"):
        port_run(data, [CPU] * 2)


class FakeLibc:
    def __init__(self, result=1):
        self.calls, self.result = [], result

    def mallopt(self, param, value):
        self.calls.append((param, value))
        return self.result


@pytest.mark.parametrize("result", [1, 0])
def test_tune_host_allocator_sets_both_thresholds_once(monkeypatch,
                                                       result):
    libc = FakeLibc(result)
    opened = []

    def cdll(name, **kw):
        opened.append(name)
        return libc

    monkeypatch.setattr(allocator, "_tuned", False)
    monkeypatch.setattr(allocator.ctypes, "CDLL", cdll)
    assert allocator.tune_host_allocator() is bool(result)
    assert opened == ["libc.so.6"]
    want = [(-3, 1 << 28), (-1, 1 << 28)] if result else [(-3, 1 << 28)]
    assert libc.calls == want
    allocator.tune_host_allocator()
    # tuned once a process; a refusal is asked again
    assert libc.calls == (want if result else want * 2)


def test_tune_host_allocator_off_glibc(monkeypatch):
    def cdll(name, **kw):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(allocator, "_tuned", False)
    monkeypatch.setattr(allocator.ctypes, "CDLL", cdll)
    assert allocator.tune_host_allocator() is False
    monkeypatch.setattr(allocator.ctypes, "CDLL", lambda name, **k: object())
    assert allocator.tune_host_allocator() is False
    assert allocator._tuned is False


def test_tune_host_allocator_runs_where_jax_runs_it(data, monkeypatch):
    """native.load() and the CLI's dispatch call it, as JAX's library
    load and setup_jax do."""
    calls = []
    monkeypatch.setattr(allocator, "tune_host_allocator",
                        lambda: calls.append(1) or True)
    native.load()
    assert calls == [1]
    with pytest.raises(ValueError, match="does not exist"):
        cli.main(["train", "--train_file", str(data["dir"] / "none.tsv"),
                  "--valid_file", data["valid"], "--model_dir",
                  str(data["dir"] / "m"), "--device", "cpu"])
    assert calls == [1, 1]
