"""The port's denoise under a launch of N ranks against the JAX package's
denoise in one process over an N-device CPU mesh (``make_mesh`` cut to N
of the 8 virtual CPU devices), on the CPU: ranks over gloo
(tests/torch_launch.py starts them as torchrun would), the narrow
signal_bilstm (hidden 32, 2 comb layers), 200 rows, ``--iterations 2
--rounds 1 --epoch_num 2``, float32, dropout 0, and JAX's initial
parameters for every mini-training seed in both packages (the ranks read
them from a file: torch_launch's ``init_params`` option).

Cases: 2 ranks on the global-batch plane; 3 ranks, where the 100-row
halves and ``--batch_size 64`` (66 rounded, 22 a rank) leave rank 2's
share of each epoch's tail step all padding; 2 ranks on the
sharded-resident plane (``DSP_DENOISE_RESIDENT_MIN_ROWS=0``, JAX's
``RESIDENT_MIN_ROWS`` set to 0). Each holds the final file byte for byte,
the first iteration's mean scores within 1e-5 with no mean within 1e-4
of ``score_cf`` (as tests/test_torch_denoise.py), only rank 0 writing
or removing a file, and every rank drawing JAX's halves and seeds in
both iterations. Then the CLI itself at 2 ranks, and the plane rule and
the global-batch split without a launch.

JAX runs in this process and the ranks in others, under other
PYTHONHASHSEEDs: the 200 rows' k-mers are distinct, so the k-mer
reselection samples nothing in the sets' hash order (ROADMAP Queue 3).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_synthetic import write_feature_file
from test_torch_denoise import NARROW, SCORE_CF, jax_cfg, noisy_rows
from torch_launch import (cli, half_digest, launch, rank_runs,
                          save_init_params)

import deepsignal_plant_tpu.pipeline.denoise as jax_denoise
from deepsignal_plant_tpu import cli as jax_cli
from deepsignal_plant_tpu.io.dataset import FeatureDataset as JaxDataset
from deepsignal_plant_tpu.models import bilstm as jax_bilstm
from deepsignal_plant_tpu_torch.config import ModelConfig, TrainConfig
from deepsignal_plant_tpu_torch.io.dataset import FeatureDataset
from deepsignal_plant_tpu_torch.pipeline import denoise as port_denoise
from deepsignal_plant_tpu_torch.pipeline import train as port_train

#: case -> (ranks, sharded-resident plane)
CASES = {"global2": (2, False), "global3": (3, False), "sharded2": (2, True)}
FLAGS = ["--model_type", "signal_bilstm", "--dropout_rate", "0",
         "--compute_dtype", "float32", "--fst_iter_prob", "--iterations",
         "2", "--rounds", "1", "--kept_ratio", "1.01", "--seed", "11",
         *NARROW]


def read_scores(path: str) -> np.ndarray:
    with open(path) as fh:
        return np.array([float(ln.split("\t")[1]) for ln in fh])


def run_jax(d, rows, ndev: int, sharded: bool, init_cache: dict) -> dict:
    """JAX's denoise over an ndev-device mesh in this process; its final
    file, scores, files left and draws."""
    draws = []
    real_tts = jax_denoise.CrossRankTrainer.train_then_score

    def spy(self, train_ds, score_ds, seed, *a, **k):
        draws.append([seed, len(train_ds), half_digest(train_ds)])
        return real_tts(self, train_ds, score_ds, seed, *a, **k)

    def jax_init(key, cfg):
        seed = int(np.asarray(key)[-1])     # PRNGKey(seed) = [0, seed]
        if seed not in init_cache:
            init_cache[seed] = jax.tree_util.tree_map(
                np.asarray,
                jax_bilstm.init_params(jax.random.PRNGKey(seed), jax_cfg()))
        return jax.tree_util.tree_map(jnp.asarray, init_cache[seed])

    real_mesh = jax_denoise.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_denoise, "init_params", jax_init)
        mp.setattr(jax_denoise, "make_mesh",
                   lambda *a, **k: real_mesh(jax.devices()[:ndev]))
        mp.setattr(jax_denoise.CrossRankTrainer, "train_then_score", spy)
        if sharded:
            mp.setattr(jax_denoise.CrossRankTrainer, "RESIDENT_MIN_ROWS", 0)
        d.mkdir()
        src = write_feature_file(str(d / "noisy.tsv"), rows)
        args = jax_cli.build_parser().parse_args(
            ["denoise", "--train_file", src, "--recurrence", "scan",
             *FLAGS])
        final = jax_denoise.denoise(args)
    with open(final, "rb") as fh:
        data = fh.read()
    return {"final": os.path.relpath(final, d), "bytes": data,
            "scores": read_scores(src + ".probs_1stiter.txt"),
            "files": sorted(os.listdir(d)), "draws": draws}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through JAX in this process, then through the port in
    two launches (2 ranks: the 2-rank cases in turn; 3 ranks)."""
    tmp = tmp_path_factory.mktemp("dist_denoise")
    rows = noisy_rows(5, 8, 25)
    init_cache: dict = {}
    out = {case: {"jax": run_jax(tmp / f"jax_{case}", rows, ndev, sharded,
                                 init_cache)}
           for case, (ndev, sharded) in CASES.items()}
    init = str(tmp / "init.npz")
    save_init_params(init, init_cache)
    for world in (2, 3):
        plan = []
        for case, (ndev, sharded) in CASES.items():
            if ndev != world:
                continue
            d = tmp / f"port_{case}"
            d.mkdir()
            src = write_feature_file(str(d / "noisy.tsv"), rows)
            opts = {"init_params": init, "watch": str(d),
                    "env": {"DSP_DENOISE_RESIDENT_MIN_ROWS":
                            "0" if sharded else "100000"}}
            plan.append((case, d, src, [
                str(d / "rank{rank}.npz"),
                ["denoise", "--train_file", src, "--device", "cpu",
                 "--verbose_stages", *FLAGS], opts]))
        outs = launch(rank_runs([p[3] for p in plan]), world, timeout=600)
        for r, (rc, text) in enumerate(outs):
            assert rc == 0, f"rank {r} of {world}:\n{text[-4000:]}"
        for i, (case, d, src, _) in enumerate(plan):
            ranks = []
            for r in range(world):
                with np.load(d / f"rank{r}.npz") as z:
                    ranks.append(json.loads(z["result"].tobytes()))
                os.remove(d / f"rank{r}.npz")
            text = [o.split("[rank] run ")[i + 1] for _, o in outs]
            stages = [json.loads(ln[len("[stages] "):]) for t in text
                      for ln in t.splitlines() if ln.startswith("[stages] ")]
            with open(ranks[0]["final"], "rb") as fh:
                data = fh.read()
            out[case]["port"] = {
                "final": os.path.relpath(ranks[0]["final"], d),
                "bytes": data,
                "scores": read_scores(src + ".probs_1stiter.txt"),
                "files": sorted(os.listdir(d)), "ranks": ranks,
                "stages": stages, "text": text}
    return out


@pytest.mark.parametrize("case", CASES)
def test_final_file_matches_jax(runs, case):
    jax_run, port = runs[case]["jax"], runs[case]["port"]
    assert port["final"] == jax_run["final"] == \
        "noisy.signal_bilstm.denoise_fp2.tsv"
    assert port["files"] == jax_run["files"]
    assert port["bytes"] == jax_run["bytes"]
    assert all(r["final"] == port["ranks"][0]["final"]
               for r in port["ranks"])


@pytest.mark.parametrize("case", CASES)
def test_mean_scores_match_jax(runs, case, capsys):
    jscores, pscores = runs[case]["jax"]["scores"], \
        runs[case]["port"]["scores"]
    margin = float(np.abs(jscores - SCORE_CF).min())
    dmax = float(np.abs(pscores - jscores).max())
    with capsys.disabled():
        print(f"\ndenoise {case}: {len(jscores)} rows, max |mean score "
              f"port - JAX| {dmax:.3g}, smallest |mean - score_cf| "
              f"{margin:.3g}")
    assert margin > 1e-4
    assert dmax <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_only_rank0_writes(runs, case):
    ranks = runs[case]["port"]["ranks"]
    assert ranks[0]["writes"], "rank 0 wrote nothing"
    for r in ranks[1:]:
        assert r["writes"] == [], f"rank {r['rank']} wrote {r['writes']}"
    # only rank 0 prints the progress lines
    text = runs[case]["port"]["text"]
    assert "cross rank to clean samples" in text[0]
    assert all("cross rank to clean samples" not in t for t in text[1:])


@pytest.mark.parametrize("case", CASES)
def test_every_rank_draws_jaxs_halves(runs, case):
    """The same seeds and halves on every rank, in both iterations (the
    second's halves follow rank 0's shuffle), and JAX's."""
    want = runs[case]["jax"]["draws"]
    assert len(want) == 4
    for r in runs[case]["port"]["ranks"]:
        assert r["draws"] == want, f"rank {r['rank']}"


@pytest.mark.parametrize("case", CASES)
def test_rank_counters(runs, case):
    """Each rank's plane, batch share and steps: the global batch is 64
    rounded up to the ranks, every rank runs every step, and over the
    ranks each epoch trains each row of its half once (one or two
    epochs a mini-training: the early break)."""
    world, sharded = CASES[case]
    B = -(-64 // world) * world
    stages = runs[case]["port"]["stages"]
    halves = [n for _, n, _ in runs[case]["jax"]["draws"]]
    assert [s["rank"] for s in stages] == list(range(world))
    for s in stages:
        assert (s["world_size"], s["batch_size"], s["local_batch"]) == (
            world, B, B // world)
        assert s["sharded_trainings"] == (4 if sharded else 0)
        assert s["resident_trainings"] == 4
        assert s["mini_trainings"] == 4 and s["iterations_run"] == 2
        assert s["steps"] == stages[0]["steps"]
        assert s["accuracy_checks"] == stages[0]["accuracy_checks"]
    one_epoch = sum(-(-n // B) for n in halves)
    assert one_epoch <= stages[0]["steps"] <= 2 * one_epoch
    rows = sum(s["train_rows"] for s in stages)
    assert sum(halves) <= rows <= 2 * sum(halves)
    # an epoch of s steps trains s * B rows less the tail's padding
    assert rows > stages[0]["steps"] * (B - B // world) - B * 4


def test_cli_under_a_two_rank_launch(tmp_path):
    """``python -m deepsignal_plant_tpu_torch denoise`` at 2 ranks, its
    own parameters and dropout: it runs, rank 0 alone prints the
    progress, every rank names the same final file, and the directory
    holds the input and that file only."""
    src = write_feature_file(str(tmp_path / "noisy.tsv"),
                             noisy_rows(6, 6, 25))
    outs = launch(cli("denoise", "--train_file", src, "--device", "cpu",
                      "--iterations", "1", "--rounds", "1", "--seed", "3",
                      "--dropout_rate", "0.2", "--verbose_stages", *NARROW),
                  2, timeout=300)
    finals = []
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r}:\n{out[-4000:]}"
        st = json.loads(next(ln for ln in out.splitlines()
                             if ln.startswith("[stages] "))[9:])
        assert (st["rank"], st["world_size"]) == (r, 2)
        finals.append(st["final_file"])
        assert ("denoised file for training" in out) == (r == 0)
    assert finals[0] == finals[1]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["noisy.tsv", os.path.basename(finals[0])])


def tiny_dataset(n: int, seed: int = 0) -> FeatureDataset:
    rng = np.random.default_rng(seed)
    return FeatureDataset(
        rng.integers(0, 4, (n, 13)).astype(np.int32),
        rng.normal(size=(n, 13)).astype(np.float32),
        rng.normal(size=(n, 13)).astype(np.float32),
        rng.integers(1, 9, (n, 13)).astype(np.float32),
        rng.normal(size=(n, 13, 16)).astype(np.float32),
        np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("n,world,local_b", [(100, 3, 22), (7, 2, 4),
                                             (64, 2, 32)])
def test_global_batch_split_is_jaxs(n, world, local_b, resident):
    """The ranks' shares of each step are the JAX iter_batches global
    batch (pad_to_batch) split in device order, masks included; a rank
    whose share is all padding still yields its step."""
    ds = tiny_dataset(n)
    jds = JaxDataset(ds.kmer, ds.base_means, ds.base_stds,
                     ds.base_signal_lens, ds.signals, ds.labels)
    want = list(jds.iter_batches(world * local_b, shuffle=True,
                                 rng=np.random.default_rng(5),
                                 pad_to_batch=True))
    got = [list(port_train.GlobalBatch(ds, torch.device("cpu"), r, world,
                                       resident)
                .epoch(np.random.default_rng(5), local_b))
           for r in range(world)]
    for r in range(world):
        assert len(got[r]) == len(want)
        for (jb, jl, jnv), (pb, pl, mask, nv) in zip(want, got[r]):
            lo = r * local_b
            np.testing.assert_array_equal(pl.numpy(), jl[lo:lo + local_b])
            np.testing.assert_array_equal(pb.signals.numpy(),
                                          jb.signals[lo:lo + local_b])
            jmask = (np.arange(world * local_b) < jnv)[lo:lo + local_b]
            np.testing.assert_array_equal(mask.numpy(), jmask)
            assert nv == int(jmask.sum())


@pytest.mark.parametrize("rows,env,auto,want", [
    (100, "0", True, "Sharded"), (100, "101", True, "GlobalBatch"),
    (100, None, True, "GlobalBatch"), (100, "0", False, "GlobalBatch")])
def test_plane_rule_at_two_ranks(monkeypatch, rows, env, auto, want):
    """JAX's rule (denoise.py:92-107): the sharded-resident plane from
    DSP_DENOISE_RESIDENT_MIN_ROWS rows (default 100,000) with
    --device_resident auto, else the global-batch plane; one rank keeps
    the one-card rule (resident when both halves fit)."""
    if env is None:
        monkeypatch.delenv("DSP_DENOISE_RESIDENT_MIN_ROWS", raising=False)
    else:
        monkeypatch.setenv("DSP_DENOISE_RESIDENT_MIN_ROWS", env)
    monkeypatch.setattr(port_denoise, "process_info", lambda: (1, 2))
    cfg = ModelConfig(module="signal_bilstm", hidden_size=32,
                      num_layers_comb=2, dropout_rate=0.0)
    tcfg = TrainConfig(batch_size=63,
                       device_resident="auto" if auto else "never")
    trainer = port_denoise.CrossRankTrainer(cfg, tcfg, torch.device("cpu"))
    assert (trainer.batch_size, trainer.local_batch) == (64, 32)
    ds = tiny_dataset(rows)
    plane, world, resident = trainer._kind(ds, ds)
    assert (plane.__name__, world, resident) == (want, 2, auto)
    monkeypatch.setattr(port_denoise, "process_info", lambda: (0, 1))
    one = port_denoise.CrossRankTrainer(cfg, tcfg, torch.device("cpu"))
    assert one._kind(ds, ds)[0].__name__ == ("Resident" if auto
                                             else "HostFed")
