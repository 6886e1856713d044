"""The port's training path against the JAX package, on the CPU at a
narrow width (hidden 32, 2 comb layers): model gradients, the four
optimizers with the clip, the loss, the dataset, the loop from one
checkpoint, the two data planes, checkpoints both ways, and the repairs
the training path needed (the dropout rate of model_config_from_args,
trainable models, params_to_numpy).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, float32 throughout: gradients 1e-5 absolute + 1e-4 relative
(the same math in other summation orders); optimizers 1e-6 + 1e-5 on
the weights (both compute the step-count scalars in float32 in one
order; an elementwise sum may still round apart); a few SGD steps of the
whole loop 2e-5 on the weights.
"""
import re

import jax
import jax.numpy as jnp
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
from deepsignal_plant_tpu.ops import optim as jax_optim
from deepsignal_plant_tpu.utils import metrics as jax_metrics
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import (ModelConfig, TrainConfig,
                                               model_config_from_args)
from deepsignal_plant_tpu_torch.io.dataset import FeatureDataset
from deepsignal_plant_tpu_torch.models import convert
from deepsignal_plant_tpu_torch.models.bilstm import (Batch, ModelBiLSTM,
                                                      init_params)
from deepsignal_plant_tpu_torch.ops import lstm as plain
from deepsignal_plant_tpu_torch.ops import optim
from deepsignal_plant_tpu_torch.pipeline import train as port_train
from deepsignal_plant_tpu_torch.utils import metrics

MODULES = ["both_bilstm", "seq_bilstm", "signal_bilstm"]
NARROW = dict(hidden_size=32, num_layers_comb=2, dropout_rate=0.0)
NARROW_FLAGS = ["--hid_rnn", "32", "--layernum1", "2"]
CPU = torch.device("cpu")


def numpy_batch(n=24, seed=0, L=13, S=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, (n, L)).astype(np.int32),
            rng.normal(size=(n, L)).astype(np.float32),
            np.abs(rng.normal(size=(n, L))).astype(np.float32),
            rng.integers(1, 30, (n, L)).astype(np.float32),
            rng.normal(size=(n, L, S)).astype(np.float32),
            rng.integers(0, 2, n).astype(np.int64))


def flat(tree) -> dict:
    return convert._flatten(jax.tree_util.tree_map(np.asarray, tree))


def assert_trees_close(got, want, atol, rtol=0.0):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# model gradients


@pytest.mark.parametrize("recurrence", ["kernel", "scan"])
@pytest.mark.parametrize("module", MODULES)
def test_model_gradients_match_jax(module, recurrence):
    """Weighted-CE gradients of forward(train=True), dropout 0, per leaf,
    against jax.grad through JAX forward(train=True, recurrence="scan").
    The port's "kernel" runs BiLSTMRecurrence (K3 forward, K4 backward)
    with their plain versions on the CPU."""
    jcfg = JaxModelConfig(module=module, **NARROW)
    params = jax.tree_util.tree_map(
        np.asarray, jax_bilstm.init_params(jax.random.PRNGKey(0), jcfg))
    *arrays, labels = numpy_batch()
    cw = np.array([1.0, 2.5], np.float32)

    def jax_loss(p):
        logits, _ = jax_bilstm.forward(
            p, jax_bilstm.Batch(*map(jnp.asarray, arrays)), jcfg,
            train=True, dropout_rng=jax.random.PRNGKey(1))
        return jax_train.weighted_ce(logits, jnp.asarray(labels),
                                     jnp.asarray(cw))

    want_loss, want = jax.value_and_grad(jax_loss)(params)

    cfg = ModelConfig(module=module, recurrence=recurrence, **NARROW)
    model = ModelBiLSTM.from_params(params, cfg, CPU, trainable=True)
    logits, _ = model(Batch(*map(torch.from_numpy, arrays)), train=True)
    loss = port_train.weighted_ce(logits, torch.from_numpy(labels),
                                  torch.from_numpy(cw))
    loss.backward()
    got = convert._unflatten({k.replace(".", "/"): p.grad.numpy()
                              for k, p in model.named_parameters()})
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                abs=1e-6)
    assert_trees_close(got, want, atol=1e-5, rtol=1e-4)


def test_weighted_ce_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(33, 2)).astype(np.float32) * 3
    labels = rng.integers(0, 2, 33)
    cw = np.array([1.0, 4.0], np.float32)
    want = jax_train.weighted_ce(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(cw))
    got = port_train.weighted_ce(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(cw))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# optimizers, schedule, clip


def opt_params(seed=4):
    rng = np.random.default_rng(seed)
    return {"conv": rng.normal(size=(3, 4, 5)).astype(np.float32),
            "bias": rng.normal(size=(7,)).astype(np.float32),
            "dense": rng.normal(size=(6, 8)).astype(np.float32)}


@pytest.mark.parametrize("optim_type", optim.OPTIM_TYPES)
def test_optimizer_matches_optax(optim_type):
    """Ten clipped updates from one set of gradients on both sides, with
    the step schedule dropping the rate at update 4 and 8. Ranger's
    rectification starts at update 6, its Lookahead syncs at update 6.
    Gradients alternate between norms above the clip (scaled down) and
    below it (left as they are)."""
    schedule_args = (0.05, 2, 2, 0.1)
    tx = jax_optim.make_optimizer(
        optim_type, jax_optim.step_decay_schedule(*schedule_args))
    jparams = {k: jnp.asarray(v) for k, v in opt_params().items()}
    state = tx.init(jparams)
    keys = sorted(jparams)
    tparams = [torch.from_numpy(opt_params()[k]) for k in keys]
    opt = optim.Optimizer(optim_type,
                          optim.step_decay_schedule(*schedule_args), tparams)
    rng = np.random.default_rng(5)
    for step in range(10):
        scale = 1.0 if step % 2 == 0 else 1e-3
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in jparams.items()}
        jparams, state = jax_train._clip_and_update(
            tx, 0.5, jparams, state, {k: jnp.asarray(g)
                                      for k, g in grads.items()})
        opt.step(port_train.clip_by_global_norm(
            [torch.from_numpy(grads[k]) for k in keys], 0.5))
        for k, p in zip(keys, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"{k} after update {step}")


def test_schedule_matches_optax():
    args = (0.001, 7, 2, 0.1)
    want = jax_optim.step_decay_schedule(*args)
    got = optim.step_decay_schedule(*args)
    for count in range(60):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6)


def test_clip_is_the_jax_formula():
    """scale = min(1, clip / max(|g|, 1e-12)) over all leaves; torch's
    clip_grad_norm_ divides by |g| + 1e-6 instead."""
    g = [torch.full((3,), 2.0), torch.full((4,), -1.0)]
    norm = float(np.sqrt(3 * 4 + 4))
    out = port_train.clip_by_global_norm(g, 0.5)
    np.testing.assert_allclose(out[0].numpy(), 2.0 * 0.5 / norm, rtol=1e-6)
    small = [t * 1e-3 for t in g]
    for a, b in zip(port_train.clip_by_global_norm(small, 0.5), small):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    zero = port_train.clip_by_global_norm([torch.zeros(3)], 0.5)
    assert torch.isfinite(zero[0]).all() and not zero[0].any()


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="optim_type"):
        optim.Optimizer("Adagrad", optim.step_decay_schedule(1, 1, 1, 1),
                        [torch.zeros(2)])


# ---------------------------------------------------------------------------
# dataset, metrics, checkpoint helpers


def write_tsv(path, seed, n_reads, sites=24):
    rng = np.random.default_rng(seed)
    return write_feature_file(str(path),
                              synth_feature_rows(rng, n_reads, sites))


def test_dataset_matches_jax(tmp_path):
    path = write_tsv(tmp_path / "f.tsv", 0, 5)
    got, want = FeatureDataset.from_file(path), JaxDataset.from_file(path)
    fields = ("kmer", "base_means", "base_stds", "base_signal_lens",
              "signals", "labels")
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.nbytes == jax_train.dataset_nbytes(want)
    idx = np.array([5, 0, 7])
    for f in fields:
        np.testing.assert_array_equal(getattr(got.take(idx), f),
                                      getattr(want.take(idx), f))
    it_got = got.iter_batches(50, shuffle=True,
                              rng=np.random.default_rng(1),
                              pad_to_batch=True)
    it_want = want.iter_batches(50, shuffle=True,
                                rng=np.random.default_rng(1),
                                pad_to_batch=True)
    for (bg, lg, ng), (bw, lw, nw) in zip(it_got, it_want, strict=True):
        assert ng == nw
        np.testing.assert_array_equal(lg, lw)
        for a, b in zip(bg, bw):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not yet ported"):
        FeatureDataset.from_file(str(tmp_path / "f.npz"))


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    for y, p in [(rng.integers(0, 2, 101), rng.integers(0, 2, 101)),
                 (np.zeros(5, int), np.zeros(5, int)), ([], [])]:
        for fn in ("accuracy", "precision", "recall"):
            assert getattr(metrics, fn)(y, p) == getattr(jax_metrics, fn)(
                y, p)


def test_ckpt_names_and_cleaning_match_jax(tmp_path):
    assert port_train.ckpt_name("d", "both_bilstm", 13, 16, 3) == \
        jax_train.ckpt_name("d", "both_bilstm", 13, 16, 3)
    for name in ("both_bilstm.b13_s16_epoch1.ckpt.npz",
                 "both_bilstm.b13_s16_epoch2.ckpt",
                 "seq_bilstm.b13_s16_epoch1.ckpt.npz", "notes.txt"):
        (tmp_path / name).write_text("x")
    port_train.clean_old_ckpts(str(tmp_path), "both_bilstm")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "notes.txt", "seq_bilstm.b13_s16_epoch1.ckpt.npz"]


# ---------------------------------------------------------------------------
# the repairs: dropout rate per entry point, trainable models,
# params_to_numpy


def test_model_config_from_args_takes_the_dropout_rate():
    parser = cli.build_parser()
    base = ["--train_file", "t", "--valid_file", "v", "--model_dir", "m"]
    args = parser.parse_args(["train", *base])
    assert model_config_from_args(args, CPU, args.dropout_rate
                                  ).dropout_rate == 0.5
    args = parser.parse_args(["train", *base, "--dropout_rate", "0.25"])
    assert model_config_from_args(args, CPU, args.dropout_rate
                                  ).dropout_rate == 0.25
    args = parser.parse_args(["call_mods", "-i", "f", "-m", "m", "-o", "o"])
    assert model_config_from_args(args, CPU, args.dropout_rate
                                  ).dropout_rate == 0.0
    assert model_config_from_args(args, CPU, 0.7).dropout_rate == 0.7


def test_from_params_trainable_and_params_to_numpy_round_trip():
    cfg = ModelConfig(**NARROW)
    params = init_params(cfg, seed=2)
    frozen = ModelBiLSTM.from_params(params, cfg, CPU)
    assert not frozen.training
    assert not any(p.requires_grad for p in frozen.parameters())
    model = ModelBiLSTM.from_params(params, cfg, CPU, trainable=True)
    assert model.training
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    back = convert.params_to_numpy(model)
    assert_trees_close(back, params, atol=0)
    jparams = jax_bilstm.init_params(jax.random.PRNGKey(0),
                                     JaxModelConfig(**NARROW))
    assert sorted(flat(back)) == sorted(flat(jparams))


def test_train_false_and_dropout():
    """Inference ignores the dropout rate; training with dropout needs a
    generator, draws the same masks from the same seed, and another
    step's generator draws others; a rate-0 training forward is the
    inference forward."""
    cfg = ModelConfig(**{**NARROW, "dropout_rate": 0.5})
    model = ModelBiLSTM.from_params(init_params(cfg, 1), cfg, CPU,
                                    trainable=True)
    *arrays, _ = numpy_batch(seed=7)
    batch = Batch(*map(torch.from_numpy, arrays))
    with torch.no_grad():
        ev = model(batch)[0]
        np.testing.assert_array_equal(model(batch)[0].numpy(), ev.numpy())
        with pytest.raises(ValueError, match="generator"):
            model(batch, train=True)
        a = model(batch, train=True,
                  generator=port_train.step_generator(1, 3, CPU))[0]
        b = model(batch, train=True,
                  generator=port_train.step_generator(1, 3, CPU))[0]
        c = model(batch, train=True,
                  generator=port_train.step_generator(1, 4, CPU))[0]
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert not torch.equal(a, c) and not torch.equal(a, ev)
        model.cfg = cfg.with_(dropout_rate=0.0)
        np.testing.assert_allclose(model(batch, train=True)[0].numpy(),
                                   ev.numpy(), atol=1e-5)


@pytest.mark.parametrize("module", MODULES)
def test_fused_off_inference_matches_the_fused_path(module, monkeypatch):
    """With _FUSED_ENABLED off, inference runs the batch-major structure
    (on the card its recurrence is K2): the same logits as the fused
    path in float32, within the other summation order's 2e-5."""
    from deepsignal_plant_tpu_torch.models import bilstm
    cfg = ModelConfig(module=module, **NARROW)
    model = ModelBiLSTM.from_params(init_params(cfg, 4), cfg, CPU)
    *arrays, _ = numpy_batch(seed=9)
    batch = Batch(*map(torch.from_numpy, arrays))
    with torch.no_grad():
        fused = model(batch)[0]
        monkeypatch.setattr(bilstm, "_FUSED_ENABLED", False)
        unfused = model(batch)[0]
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), atol=2e-5,
                               rtol=0)


def test_dropout_mask_statistics():
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(0)
    y = plain.dropout(x, 0.3, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.7, rtol=1e-6)
    assert plain.dropout(x.bfloat16(), 0.3, gen).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the loop: against JAX from one checkpoint; the two data planes


def accuracies(text: str) -> list[str]:
    return re.findall(r"Accuracy: ([0-9.]+)", text)


@pytest.fixture()
def single_device_mesh(monkeypatch):
    real = jax_train.make_mesh
    monkeypatch.setattr(jax_train, "make_mesh",
                        lambda *a, **k: real(jax.devices()[:1]))


def test_train_cli_matches_jax_loop(tmp_path, capsys, single_device_mesh):
    """One JAX npz checkpoint; JAX train_loop (host-fed, SGD, dropout 0,
    recurrence scan) and the port's train CLI on the CPU from it: the
    same validation accuracies at every eval boundary, the same final
    weights within 2e-5. The port's best checkpoint then loads in the
    JAX package and gives the port's logits."""
    tr = write_tsv(tmp_path / "train.tsv", 1, 16)     # 384 rows: 6 steps
    va = write_tsv(tmp_path / "valid.tsv", 2, 4)
    jcfg = JaxModelConfig(**NARROW)
    init = str(tmp_path / "init.ckpt.npz")
    jax_convert.save_checkpoint(
        init, jax_bilstm.init_params(jax.random.PRNGKey(3), jcfg), jcfg)
    common = dict(batch_size=64, lr=0.05, max_epoch_num=2, min_epoch_num=2,
                  step_interval=4, optim_type="SGD")
    want = jax_train.train_loop(
        jcfg, JaxTrainConfig(device_resident="never", **common),
        JaxDataset.from_file(tr), JaxDataset.from_file(va), None,
        init_model=init)
    want_acc = accuracies(capsys.readouterr().out)

    args = cli.build_parser().parse_args([
        "train", "--train_file", tr, "--valid_file", va, "--model_dir",
        str(tmp_path / "port"), "--device", "cpu", "--init_model", init,
        "--dropout_rate", "0", "--batch_size", "64", "--lr", "0.05",
        "--max_epoch_num", "2", "--min_epoch_num", "2", "--step_interval",
        "4", "--optim_type", "SGD", *NARROW_FLAGS])
    got = port_train.train(args)
    got_acc = accuracies(capsys.readouterr().out)
    assert len(want_acc) == 4 and got_acc == want_acc
    assert got["best_accuracy"] == want["best_accuracy"]
    assert got["steps"] == 12 and got["epochs_run"] == 2
    assert_trees_close(got["params"], want["params"], atol=2e-5)

    jparams = jax_convert.load_any_checkpoint(got["best_ckpt"], jcfg)
    *arrays, _ = numpy_batch(seed=8)
    want_logits, _ = jax_bilstm.forward(
        jparams, jax_bilstm.Batch(*map(jnp.asarray, arrays)), jcfg)
    params, cfg = convert.load_checkpoint(got["best_ckpt"])
    model = ModelBiLSTM.from_params(params, cfg, CPU)
    with torch.no_grad():
        logits, _ = model(Batch(*map(torch.from_numpy, arrays)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("n_train,step_interval", [(384, 3), (200, 3)],
                         ids=["even", "ragged_tail"])
def test_resident_plane_is_bitwise_the_host_fed_plane(tmp_path, n_train,
                                                      step_interval):
    """Same seed and data, dropout 0.5: the device-resident plane and the
    host-fed plane take the same rows, the same dropout masks and the
    same updates, so their weights are bitwise equal on the CPU (on a
    card the embedding gradient accumulates with atomics, so only within
    a tolerance)."""
    rng = np.random.default_rng(9)
    rows = synth_feature_rows(rng, 20, 24)
    tr = write_feature_file(str(tmp_path / "t.tsv"), rows[:n_train])
    va = write_feature_file(str(tmp_path / "v.tsv"), rows[400:460])
    cfg = ModelConfig(**{**NARROW, "dropout_rate": 0.5})
    runs = {}
    for plane in ("never", "auto"):
        tcfg = TrainConfig(batch_size=64, max_epoch_num=2, min_epoch_num=2,
                           step_interval=step_interval,
                           device_resident=plane)
        runs[plane] = port_train.train_loop(
            cfg, tcfg, FeatureDataset.from_file(tr),
            FeatureDataset.from_file(va), None, CPU, verbose=False)
    host, res = runs["never"], runs["auto"]
    assert not host["resident"] and res["resident"]
    assert host["valid_accuracies"] == res["valid_accuracies"]
    assert host["step_losses"] == res["step_losses"]
    assert_trees_close(res["params"], host["params"], atol=0)


# ---------------------------------------------------------------------------
# what is not ported yet fails, before any work


@pytest.mark.parametrize("flags,match", [
    (["--resume"], "--resume"),
    (["--stream", "yes"], "streaming"),
    (["--device_resident", "auto"], "--device_resident never"),
], ids=["resume", "stream", "spill"])
def test_unported_planes_are_refused(tmp_path, monkeypatch, flags, match):
    monkeypatch.setattr(port_train, "resident_budget", lambda device: 0)
    tr = write_tsv(tmp_path / "t.tsv", 0, 2)
    args = cli.build_parser().parse_args([
        "train", "--train_file", tr, "--valid_file", tr, "--model_dir",
        str(tmp_path / "m"), "--device", "cpu", *NARROW_FLAGS, *flags])
    with pytest.raises(ValueError, match=match):
        port_train.train(args)
    assert not (tmp_path / "m").exists() or not any(
        (tmp_path / "m").iterdir())
