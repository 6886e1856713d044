"""The port's call_mods (deepsignal_plant_tpu_torch) against the JAX
engine on the same features TSV and checkpoint, on the CPU.

Gate: at float32 wire and float32 compute, columns 1-6 and 10 of every
row are identical and both probabilities agree within 2e-6 after the
6-decimal rounding of the output (one rounding step, 1e-6, on either
side); any row whose called label differs is listed.
"""
import gzip
import os

import jax
import numpy as np
import pytest

from deepsignal_plant_tpu.config import CallConfig as JaxCallConfig
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.models.bilstm import init_params as jax_init
from deepsignal_plant_tpu.models.convert import save_checkpoint
from deepsignal_plant_tpu.parallel.mesh import make_mesh
from deepsignal_plant_tpu.pipeline.call_mods import \
    CallModsEngine as JaxEngine
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import CallConfig, ModelConfig
from deepsignal_plant_tpu_torch.pipeline import call_mods as port_call_mods
from make_synthetic import synth_feature_rows, write_feature_file

NARROW = dict(hidden_size=32, num_layers_comb=2)
NARROW_FLAGS = ["--hid_rnn", "32", "--layernum1", "2"]
PROB_TOL = 2e-6


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxModelConfig(**NARROW)
    path = str(tmp_path_factory.mktemp("ckpt") / "narrow.ckpt.npz")
    save_checkpoint(path, jax_init(jax.random.PRNGKey(7), cfg), cfg)
    return path


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    rows = synth_feature_rows(np.random.default_rng(11), n_reads=9,
                              sites_per_read=23)
    path = str(tmp_path_factory.mktemp("feat") / "features.tsv")
    return write_feature_file(path, rows), len(rows)


def read_rows(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


def run_port(features, ckpt, out, *extra):
    cli.main(["call_mods", "-i", features, "-m", ckpt, "-o", out,
              "--device", "cpu", *NARROW_FLAGS, *extra])
    return read_rows(out)


def assert_rows_agree(got, want):
    assert len(got) == len(want)
    flips = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
             if g[8] != w[8]]
    assert not flips, f"called label differs on rows {flips}"
    for g, w in zip(got, want):
        assert len(g) == 10
        assert g[:6] == w[:6] and g[9] == w[9]
        assert abs(float(g[6]) - float(w[6])) <= PROB_TOL
        assert abs(float(g[7]) - float(w[7])) <= PROB_TOL


def test_call_mods_matches_jax_engine(ckpt, features, tmp_path):
    feat_path, n_rows = features
    jcfg = JaxModelConfig(recurrence="scan", compute_dtype="float32",
                          dropout_rate=0.0, **NARROW)
    eng = JaxEngine(ckpt, jcfg, JaxCallConfig(transfer_dtype="float32"),
                    mesh=make_mesh(jax.devices()[:1]))
    want_path = str(tmp_path / "jax.tsv")
    eng.run_features_file(feat_path, want_path, use_fast_path=False)
    want = read_rows(want_path)
    got = run_port(feat_path, ckpt, str(tmp_path / "port.tsv"),
                   "--compute_dtype", "float32",
                   "--transfer_dtype", "float32")
    assert len(got) == n_rows
    assert_rows_agree(got, want)


def test_small_device_batch_and_tiles_give_the_same_rows(
        ckpt, features, tmp_path, monkeypatch):
    """Blocks of 50 rows in 16-row forward tiles (ragged tails in both)
    write the same rows as one block in one tile, and count the tiles."""
    feat_path, n_rows = features
    one = run_port(feat_path, ckpt, str(tmp_path / "one.tsv"),
                   "--compute_dtype", "float32")
    monkeypatch.setattr(port_call_mods, "COMPUTE_TILE", 16)
    cfg = ModelConfig(compute_dtype="float32", dropout_rate=0.0, **NARROW)
    eng = port_call_mods.CallModsEngine(
        ckpt, cfg, CallConfig(device_batch=50), "cpu")
    stats = eng.run_features_file(feat_path, str(tmp_path / "tiled.tsv"),
                                  is_gzip=True)
    tiled = read_rows(str(tmp_path / "tiled.tsv.gz"))
    assert stats.sites == n_rows
    assert stats.batches == -(-n_rows // 50)
    assert stats.forward_tiles == sum(-(-min(50, n_rows - lo) // 16)
                                      for lo in range(0, n_rows, 50))
    assert_rows_agree(tiled, one)


def test_float16_wire_stays_close_to_float32(ckpt, features, tmp_path):
    feat_path, _ = features
    f32 = run_port(feat_path, ckpt, str(tmp_path / "f32.tsv"),
                   "--compute_dtype", "float32", "--transfer_dtype",
                   "float32")
    f16 = run_port(feat_path, ckpt, str(tmp_path / "f16.tsv"),
                   "--compute_dtype", "float32")
    dp = max(abs(float(a[7]) - float(b[7])) for a, b in zip(f16, f32))
    assert dp < 1e-3


@pytest.mark.parametrize("flag", [
    ["--transfer_dtype", "int8"], ["--device_resident", "always"],
    ["--profile_dir", "prof"]])
def test_unported_flags_fail_clearly(ckpt, features, tmp_path, flag):
    """The flags the port used to refuse now run: every row is called,
    with the default run's info columns and k-mers (the int8 wire's
    probabilities differ; tests/test_torch_int8.py holds them against
    JAX). Where JAX fails on them, the port fails clearly too: a gzipped
    TSV under --device_resident always, before any output is opened."""
    feat_path, n_rows = features
    want = run_port(feat_path, ckpt, str(tmp_path / "default.tsv"))
    flag = [str(tmp_path / a) if a == "prof" else a for a in flag]
    got = run_port(feat_path, ckpt, str(tmp_path / "x.tsv"), *flag)
    assert len(got) == n_rows
    assert [r[:6] + r[9:] for r in got] == [r[:6] + r[9:] for r in want]
    if flag[0] == "--device_resident":
        assert got == want
        gz = tmp_path / "f.tsv.gz"
        with open(feat_path, "rb") as src, gzip.open(gz, "wb") as dst:
            dst.write(src.read())
        with pytest.raises(ValueError, match="plain features TSV"):
            run_port(str(gz), ckpt, str(tmp_path / "y.tsv"), *flag)
        assert not (tmp_path / "y.tsv").exists()
    if flag[0] == "--profile_dir":
        assert [f for f in os.listdir(flag[1]) if f.endswith(".json")]


def test_unported_inputs_fail_clearly(ckpt, tmp_path):
    """.npz inputs are read now; one that is not a feature container
    fails clearly with the JAX loader's message, as a file and as a
    directory."""
    npz = tmp_path / "batch.npz"
    np.savez(npz, x=np.zeros(1))
    for path in (str(npz), str(tmp_path)):
        with pytest.raises(ValueError, match="inference container"):
            run_port(path, ckpt, str(tmp_path / "x.tsv"))


def test_default_device_is_the_card(ckpt, features, tmp_path):
    """Without --device the run asks for a card: here, with none, it
    fails instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["call_mods", "-i", features[0], "-m", ckpt, "-o",
                  str(tmp_path / "x.tsv"), *NARROW_FLAGS])
