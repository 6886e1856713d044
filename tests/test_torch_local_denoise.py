"""denoise over several devices of one process (``CrossRankTrainer``
over a list of devices) against the JAX package's denoise in one process
over an N-device CPU mesh (``make_mesh`` cut to N of the 8 virtual CPU
devices), on the CPU: the narrow signal_bilstm (hidden 32, 2 comb
layers), 200 rows, ``--iterations 2 --rounds 1 --epoch_num 2``, float32,
dropout 0, JAX's initial parameters for every mini-training seed in
both packages (tests/test_torch_dist_denoise.py's case and JAX runs).

Cases: 2 and 3 devices on the global-batch plane (at 3 the 100-row
halves and ``--batch_size 64``, 66 rounded, leave device 2's share of
each epoch's tail step all padding) and on the sharded-resident plane
(``DSP_DENOISE_RESIDENT_MIN_ROWS=0``, JAX's ``RESIDENT_MIN_ROWS`` 0).
Each writes JAX's final file byte for byte and leaves JAX's files, with
the first iteration's mean scores within 1e-5 and every mini-training
drawing JAX's halves and seeds; the replicas' parameters are bitwise
equal after every step, and the counters say what ran. Then the plane
rule over local devices, and the CLI over ``[cpu] * 2`` with dropout.
"""
import json
import os

import numpy as np
import pytest
import torch

from make_synthetic import write_feature_file
from test_torch_denoise import NARROW, SCORE_CF, noisy_rows
from test_torch_dist_denoise import FLAGS, read_scores, run_jax, tiny_dataset
from torch_launch import half_digest

from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import ModelConfig, TrainConfig
from deepsignal_plant_tpu_torch.pipeline import denoise as port_denoise
from deepsignal_plant_tpu_torch.pipeline import train as port_train

CPU = torch.device("cpu")
#: case -> (devices, sharded-resident plane)
CASES = {"global2": (2, False), "global3": (3, False),
         "sharded2": (2, True), "sharded3": (3, True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def on_devices(mp, devices: list) -> None:
    """``denoise`` takes ``devices`` where resolve_devices would give the
    process's cards."""
    mp.setattr(port_denoise, "resolve_devices", lambda choice: devices)


def run_port(d, rows, n: int, sharded: bool, init: dict) -> dict:
    """The port's denoise over ``[cpu] * n`` in this process; its final
    file, scores, files left, draws, stages and per-step checks."""
    draws, steps = [], []
    real_tts = port_denoise.CrossRankTrainer.train_then_score
    real_step = port_denoise.train_step

    def spy_tts(self, train_ds, score_ds, seed, *a, **k):
        draws.append([seed, len(train_ds), half_digest(train_ds)])
        return real_tts(self, train_ds, score_ds, seed, *a, **k)

    def spy_step(reps, parts, clip, gens):
        loss = real_step(reps, parts, clip, gens)
        steps.append(all(torch.equal(w, w0) for r in reps[1:]
                         for w, w0 in zip(r.weights, reps[0].weights)))
        return loss

    with pytest.MonkeyPatch.context() as mp:
        on_devices(mp, [CPU] * n)
        mp.setattr(port_denoise, "init_params", lambda cfg, seed: init[seed])
        mp.setattr(port_denoise.CrossRankTrainer, "train_then_score",
                   spy_tts)
        mp.setattr(port_denoise, "train_step", spy_step)
        mp.setenv("DSP_DENOISE_RESIDENT_MIN_ROWS",
                  "0" if sharded else "100000")
        d.mkdir()
        src = write_feature_file(str(d / "noisy.tsv"), rows)
        args = cli.build_parser().parse_args(
            ["denoise", "--train_file", src, "--device", "cuda",
             "--verbose_stages", *FLAGS])
        final = port_denoise.denoise(args)
    with open(final, "rb") as fh:
        data = fh.read()
    return {"final": os.path.relpath(final, d), "bytes": data,
            "scores": read_scores(src + ".probs_1stiter.txt"),
            "files": sorted(os.listdir(d)), "draws": draws,
            "steps": steps}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("local_denoise")
    rows = noisy_rows(5, 8, 25)
    init_cache: dict = {}
    out = {}
    for case, (n, sharded) in CASES.items():
        out[case] = {"jax": run_jax(tmp / f"jax_{case}", rows, n, sharded,
                                    init_cache)}
    for case, (n, sharded) in CASES.items():
        out[case]["port"] = run_port(tmp / f"port_{case}", rows, n,
                                     sharded, init_cache)
    return out


@pytest.mark.parametrize("case", CASES)
def test_final_file_matches_jax(runs, case):
    jax_run, port = runs[case]["jax"], runs[case]["port"]
    assert port["final"] == jax_run["final"] == \
        "noisy.signal_bilstm.denoise_fp2.tsv"
    assert port["files"] == jax_run["files"]
    assert port["bytes"] == jax_run["bytes"]


@pytest.mark.parametrize("case", CASES)
def test_mean_scores_and_draws_match_jax(runs, case):
    jax_run, port = runs[case]["jax"], runs[case]["port"]
    margin = float(np.abs(jax_run["scores"] - SCORE_CF).min())
    assert margin > 1e-4
    assert float(np.abs(port["scores"] - jax_run["scores"]).max()) <= 1e-5
    assert len(jax_run["draws"]) == 4
    assert port["draws"] == jax_run["draws"]


@pytest.mark.parametrize("case", CASES)
def test_replicas_bitwise_equal_after_every_step(runs, case):
    steps = runs[case]["port"]["steps"]
    assert len(steps) >= 8 and all(steps)


def test_stages_of_a_local_run(tmp_path, capsys):
    """The CLI over ``[cpu] * 2`` with its own parameters and dropout
    0.2: the [stages] line names both devices, the global batch (64 over
    2 shares of 32) and the plane counters, and the directory holds the
    input and the final file only."""
    src = write_feature_file(str(tmp_path / "noisy.tsv"),
                             noisy_rows(6, 6, 25))
    with pytest.MonkeyPatch.context() as mp:
        on_devices(mp, [CPU] * 2)
        cli.main(["denoise", "--train_file", src, "--iterations", "1",
                  "--rounds", "1", "--seed", "3", "--dropout_rate", "0.2",
                  "--verbose_stages", *NARROW])
    out = capsys.readouterr().out
    st = json.loads(next(ln for ln in out.splitlines()
                         if ln.startswith("[stages] "))[9:])
    assert (st["devices"], st["rank"], st["world_size"], st["batch_size"],
            st["local_batch"]) == (["cpu", "cpu"], 0, 1, 64, 32)
    assert (st["mini_trainings"], st["resident_trainings"],
            st["sharded_trainings"]) == (2, 2, 0)
    # each replica scores its block of a 75-row half (38 and 37 rows)
    # in two 32-row tiles
    assert st["score_tiles"] == 2 * 2 * 2
    assert st["forward_tiles"] == 2 * st["accuracy_checks"] + 8
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["noisy.tsv", os.path.basename(st["final_file"])])


@pytest.mark.parametrize("rows,env,auto,fits,want", [
    (100, "0", True, True, ("Sharded", True)),
    (100, "101", True, True, ("GlobalBatch", True)),
    (100, "0", True, False, ("GlobalBatch", False)),
    (100, "0", False, True, ("GlobalBatch", False))])
def test_plane_rule_over_local_devices(monkeypatch, rows, env, auto, fits,
                                       want):
    """JAX's N-device rule (denoise.py:92-107) over 2 local devices: the
    sharded-resident plane from DSP_DENOISE_RESIDENT_MIN_ROWS rows with
    --device_resident auto when each card holds its replicas' blocks,
    else the global-batch plane, resident when each card holds its
    replicas' copies of both halves. The planes are one a replica."""
    monkeypatch.setenv("DSP_DENOISE_RESIDENT_MIN_ROWS", env)
    ds = tiny_dataset(rows)
    both = 2 * ds.nbytes
    # two replicas on the one device: blocks of `both`, copies of 2x it
    budget = 2 * both if fits else both - 1
    monkeypatch.setattr(port_train, "resident_budget", lambda d: budget)
    cfg = ModelConfig(module="signal_bilstm", hidden_size=32,
                      num_layers_comb=2, dropout_rate=0.0)
    tcfg = TrainConfig(batch_size=63,
                       device_resident="auto" if auto else "never")
    trainer = port_denoise.CrossRankTrainer(cfg, tcfg, [CPU] * 2)
    assert (trainer.batch_size, trainer.local_batch) == (64, 32)
    plane, world, resident = trainer._kind(ds, ds)
    assert (plane.__name__, resident) == want and world == 2
    src = trainer._plane((plane, world, resident), ds)
    assert isinstance(src, port_train.Replicated)
    assert [type(p) for p in src.parts] == [plane, plane]
    if plane is port_train.GlobalBatch:
        assert [p.ds is None for p in src.parts] == [resident] * 2

