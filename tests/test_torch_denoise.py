"""The port's denoise against the JAX package's, on the CPU at a narrow
width (hidden 32, signal_bilstm with 2 comb layers, batch 64).

The port cannot reproduce jax.random's initialisation or dropout masks,
so the comparison with JAX injects the same initial parameters into both
packages (each package's ``init_params`` as its denoise module sees it
returns JAX's initialisation for that seed) and trains at dropout 0.
Then both draw the same halves, epoch orders and negatives from the same
seed, and the final file must be the same file, byte for byte. Per-row
mean scores (``--fst_iter_prob``) agree within 1e-5: the same float32
math in other summation orders. No row's mean may sit within 1e-4 of
``score_cf``, where that noise could move it across the threshold; the
test asserts and prints that margin.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_synthetic import synth_feature_rows, write_feature_file

import deepsignal_plant_tpu.pipeline.denoise as jax_denoise
from deepsignal_plant_tpu import cli as jax_cli
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.models import bilstm as jax_bilstm
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import ModelConfig, TrainConfig
from deepsignal_plant_tpu_torch.io.dataset import FeatureDataset
from deepsignal_plant_tpu_torch.pipeline import denoise as port_denoise

CPU = torch.device("cpu")
NARROW = ["--hid_rnn", "32", "--layernum1", "2", "--batch_size", "64",
          "--lr", "0.005", "--epoch_num", "2", "--step_interval", "2"]
SCORE_CF = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs
    several test files at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noisy_rows(seed: int, n_reads: int, sites: int) -> list[str]:
    """Synthetic separable rows with every fifth label-0 row flipped to 1
    (tests/test_train_denoise.py::test_denoise_loop's corruption)."""
    rows = synth_feature_rows(np.random.default_rng(seed), n_reads, sites)
    out = []
    for i, r in enumerate(rows):
        w = r.split("\t")
        if w[11] == "0" and i % 5 == 0:
            w[11] = "1"
        out.append("\t".join(w))
    return out


def jax_cfg() -> JaxModelConfig:
    return JaxModelConfig(module="signal_bilstm", hidden_size=32,
                          num_layers_comb=2, dropout_rate=0.0)


@pytest.fixture()
def same_init(monkeypatch):
    """Both packages' denoise start every mini-training from JAX's
    initialisation for its seed; JAX runs on one device."""
    cache = {}

    def params_for(seed: int):
        if seed not in cache:
            cache[seed] = jax.tree_util.tree_map(
                np.asarray,
                jax_bilstm.init_params(jax.random.PRNGKey(seed), jax_cfg()))
        return cache[seed]

    def jax_init(key, cfg):
        seed = int(np.asarray(key)[-1])     # PRNGKey(seed) = [0, seed]
        return jax.tree_util.tree_map(jnp.asarray, params_for(seed))

    monkeypatch.setattr(jax_denoise, "init_params", jax_init)
    monkeypatch.setattr(port_denoise, "init_params",
                        lambda cfg, seed: params_for(seed))
    real_mesh = jax_denoise.make_mesh
    monkeypatch.setattr(jax_denoise, "make_mesh",
                        lambda *a, **k: real_mesh(jax.devices()[:1]))


def read_scores(path: str) -> np.ndarray:
    with open(path) as fh:
        return np.array([float(ln.split("\t")[1]) for ln in fh])


def run_both(tmp_path, rows, flags):
    """JAX's and the port's denoise on the same file, each in its own
    directory; returns {package: (final file, its bytes, mean scores)}."""
    out = {}
    for pkg, parser, extra in (
            ("jax", jax_cli.build_parser(), ["--recurrence", "scan"]),
            ("port", cli.build_parser(), ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        src = write_feature_file(str(d / "noisy.tsv"), rows)
        args = parser.parse_args([
            "denoise", "--train_file", src, "--model_type", "signal_bilstm",
            "--dropout_rate", "0", "--compute_dtype", "float32",
            "--fst_iter_prob", *NARROW, *flags, *extra])
        mod = jax_denoise if pkg == "jax" else port_denoise
        final = mod.denoise(args)
        with open(final, "rb") as fh:
            data = fh.read()
        out[pkg] = (os.path.relpath(final, d), data,
                    read_scores(src + ".probs_1stiter.txt"),
                    sorted(os.listdir(d)))
    return out


@pytest.mark.parametrize("is_filter_fn", ["no", "yes"])
def test_denoise_matches_jax(tmp_path, same_init, is_filter_fn, capsys):
    rows = noisy_rows(5, 8, 25)
    res = run_both(tmp_path, rows, [
        "--is_filter_fn", is_filter_fn, "--iterations", "2", "--rounds",
        "1", "--kept_ratio", "1.01", "--seed", "11"])
    jname, jbytes, jscores, jfiles = res["jax"]
    pname, pbytes, pscores, pfiles = res["port"]
    margin = float(np.abs(jscores - SCORE_CF).min())
    dmax = float(np.abs(pscores - jscores).max())
    with capsys.disabled():
        print(f"\ndenoise is_filter_fn={is_filter_fn}: {len(jscores)} "
              f"rows, max |mean score port - JAX| {dmax:.3g}, smallest "
              f"|mean - score_cf| {margin:.3g}, final {pname}")
    assert margin > 1e-4
    assert dmax <= 1e-5
    tag = "denoise_fpnp2" if is_filter_fn == "yes" else "denoise_fp2"
    assert pname == jname == f"noisy.signal_bilstm.{tag}.tsv"
    assert pfiles == jfiles
    assert pbytes == jbytes


def test_train_then_score_planes_are_bitwise_equal():
    """One mini-training at dropout 0.5 on the resident and on the
    host-fed plane: the same rows, masks and updates, so the same scores
    bit for bit on the CPU. The swapped call that follows (a round's
    second) reuses both halves' planes."""
    path_rows = synth_feature_rows(np.random.default_rng(3), 6, 25)
    lines = [r.encode() + b"\n" for r in path_rows]
    from deepsignal_plant_tpu_torch.utils.fastparse import \
        parse_feature_bytes
    ds = FeatureDataset.concat([parse_feature_bytes(b"".join(lines))])
    h1, h2 = ds.take(np.arange(0, 150, 2)), ds.take(np.arange(1, 150, 2))
    cfg = ModelConfig(module="signal_bilstm", hidden_size=32,
                      num_layers_comb=2, dropout_rate=0.5)
    scores = {}
    for plane in ("auto", "never"):
        trainer = port_denoise.CrossRankTrainer(
            cfg, TrainConfig(batch_size=32, lr=0.005, step_interval=1,
                             device_resident=plane), CPU)
        scores[plane] = trainer.train_then_score(h1, h2, 9, 2, 1)
        assert trainer.counters["resident_trainings"] == (plane == "auto")
        assert trainer.counters["steps"] >= 3
        assert trainer.counters["score_tiles"] == 3
        assert trainer.counters["planes_built"] == 2
        trainer.train_then_score(h2, h1, 10, 1, 1)
        assert trainer.counters["planes_built"] == 2
        assert trainer.counters["mini_trainings"] == 2
    assert scores["auto"].shape == (75,) and scores["auto"].dtype == np.float32
    np.testing.assert_array_equal(scores["auto"], scores["never"])


def test_seeded_denoise_reproduces(tmp_path):
    rows = noisy_rows(6, 6, 25)
    data = []
    for run in ("a", "b"):
        d = tmp_path / run
        d.mkdir()
        src = write_feature_file(str(d / "noisy.tsv"), rows)
        args = cli.build_parser().parse_args([
            "denoise", "--train_file", src, "--device", "cpu",
            "--iterations", "1", "--rounds", "1", "--seed", "3",
            "--dropout_rate", "0.2", *NARROW])
        final = port_denoise.denoise(args)
        with open(final, "rb") as fh:
            data.append((os.path.basename(final), fh.read()))
        assert sorted(os.listdir(d)) == sorted(["noisy.tsv",
                                                os.path.basename(final)])
    assert data[0] == data[1]


def test_denoise_loop(tmp_path, capsys):
    """The narrow counterpart of tests/test_train_denoise.py::
    test_denoise_loop: 20% of the label-0 rows flipped; the run finishes
    and writes a mix of positives and k-mer-balanced negatives, and the
    CLI entry prints its counters."""
    rows = noisy_rows(33, 16, 25)
    src = write_feature_file(str(tmp_path / "noisy.tsv"), rows)
    cli.main(["denoise", "--train_file", src, "--device", "cpu",
              "--iterations", "1", "--rounds", "1", "--seed", "7",
              "--dropout_rate", "0.2", "--verbose_stages", *NARROW])
    text = capsys.readouterr().out
    out = text.split("denoised file for training: ")[1].split("\n")[0]
    assert os.path.exists(out)
    labels = [int(ln.split("\t")[11]) for ln in open(out).read().splitlines()]
    assert 0 < sum(labels) < len(labels)
    stages = [ln for ln in text.splitlines() if ln.startswith("[stages] ")]
    assert len(stages) == 1 and '"mini_trainings": 2' in stages[0]
    assert '"planes_built": 2' in stages[0]


def test_denoise_needs_the_card_unless_told():
    args = cli.build_parser().parse_args(["denoise", "--train_file", "x"])
    assert (args.device, args.model_type, args.dropout_rate,
            args.compute_dtype, args.device_resident, args.seed) == (
        "cuda", "signal_bilstm", 0.5, "auto", "auto", None)
    jargs = jax_cli.build_parser().parse_args(["denoise", "--train_file",
                                               "x"])
    for k, v in vars(jargs).items():
        if k != "func":
            assert getattr(args, k) == v, k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_denoise.denoise(args)
    # the port's CLI adds --device and --verbose_stages
    assert {"device", "verbose_stages"} <= set(vars(args)) - set(vars(jargs))
