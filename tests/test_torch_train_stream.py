"""The port's streaming training dataset against the JAX package's, on
the CPU at a narrow width (hidden 32, 2 comb layers, batch 64, dropout
0): StreamingFeatureDataset yields JAX's batches in JAX's order at
block_rows 100 (a TSV, its .gz and a v1 .npz directory), the train loop
on it ends within 2e-5 of JAX's (the same float32 math in other
summation orders), and the train CLI takes the streamed plane for
``--stream yes`` and for ``auto`` on a file over STREAM_MIN_BYTES.
"""
import gzip

import jax
import numpy as np
import pytest
import torch

from make_synthetic import synth_feature_rows, write_feature_file
from test_torch_train_resume import (NARROW, NARROW_FLAGS, accuracies,
                                     assert_trees_close, write_rows)
# the resume tests' fixtures: one torch thread, JAX on one device
from test_torch_train_resume import (one_torch_thread,  # noqa: F401
                                     single_device_mesh)  # noqa: F401

import deepsignal_plant_tpu.pipeline.train as jax_train
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.config import TrainConfig as JaxTrainConfig
from deepsignal_plant_tpu.io.dataset import FeatureDataset as JaxDataset
from deepsignal_plant_tpu.io.dataset import \
    StreamingFeatureDataset as JaxStreaming
from deepsignal_plant_tpu.models import bilstm as jax_bilstm
from deepsignal_plant_tpu.models import convert as jax_convert
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import ModelConfig, TrainConfig
from deepsignal_plant_tpu_torch.io.dataset import (FeatureDataset,
                                                   StreamingFeatureDataset)
from deepsignal_plant_tpu_torch.pipeline import train as port_train
from deepsignal_plant_tpu_torch.utils.fastparse import parse_feature_bytes
from deepsignal_plant_tpu_torch.utils.formats import save_feature_npz

CPU = torch.device("cpu")


def stream_inputs(tmp_path) -> dict:
    """A 250-row TSV (blocks of 100: a ragged last block), its .gz and a
    v1 .npz directory of three files of 90, 100 and 60 rows."""
    rows = synth_feature_rows(np.random.default_rng(4), 10, 25)
    tsv = write_feature_file(str(tmp_path / "s.tsv"), rows)
    with open(tsv, "rb") as fh, gzip.open(str(tmp_path / "s.tsv.gz"),
                                          "wb") as gz:
        gz.write(fh.read())
    d = tmp_path / "npz"
    d.mkdir()
    for i, (lo, hi) in enumerate(((0, 90), (90, 190), (190, 250))):
        block = "".join(r + "\n" for r in rows[lo:hi]).encode()
        save_feature_npz(str(d / f"{i:06d}.npz"), parse_feature_bytes(block))
    return {"tsv": tsv, "gz": str(tmp_path / "s.tsv.gz"), "npz": str(d)}


@pytest.mark.parametrize("kind", ["tsv", "gz", "npz"])
def test_streaming_batches_match_jax(tmp_path, kind):
    path = stream_inputs(tmp_path)[kind]
    got_ds = StreamingFeatureDataset(path, block_rows=100)
    want_ds = JaxStreaming(path, block_rows=100)
    assert len(got_ds) == len(want_ds) == 250
    for shuffle in (True, False):
        rg, rw = np.random.default_rng(8), np.random.default_rng(8)
        for _epoch in range(2):
            got = list(got_ds.iter_batches(64, shuffle, rg))
            want = list(want_ds.iter_batches(64, shuffle, rw,
                                             pad_to_batch=False))
            assert len(got) == len(want) == 4
            for (bg, lg), (bw, lw, nw) in zip(got, want):
                assert len(lg) == nw
                np.testing.assert_array_equal(lg, lw)
                for a, b in zip(bg, bw):
                    np.testing.assert_array_equal(a, b)
        assert rg.integers(1 << 30) == rw.integers(1 << 30)


@pytest.mark.parametrize("kind", ["tsv", "gz", "npz"])
def test_streaming_train_loop_matches_jax(tmp_path, capsys,
                                          single_device_mesh, kind):
    paths = stream_inputs(tmp_path)
    va = write_rows(tmp_path / "valid.tsv", 2, 3)
    jcfg = JaxModelConfig(**NARROW)
    init = str(tmp_path / "init.ckpt.npz")
    jax_convert.save_checkpoint(
        init, jax_bilstm.init_params(jax.random.PRNGKey(4), jcfg), jcfg)
    common = dict(batch_size=64, lr=0.05, max_epoch_num=2, min_epoch_num=2,
                  step_interval=3, optim_type="SGD")
    want = jax_train.train_loop(
        jcfg, JaxTrainConfig(**common),
        JaxStreaming(paths[kind], block_rows=100), JaxDataset.from_file(va),
        None, init_model=init)
    want_acc = accuracies(capsys.readouterr().out)
    got = port_train.train_loop(
        ModelConfig(**NARROW), TrainConfig(**common),
        StreamingFeatureDataset(paths[kind], block_rows=100),
        FeatureDataset.from_file(va), None, CPU, init_model=init)
    assert accuracies(capsys.readouterr().out) == want_acc
    assert len(want_acc) == 4
    assert got["plane"] == "stream" and got["steps"] == 8
    assert got["train_rows"] == 500
    assert_trees_close(got["params"], want["params"], atol=2e-5)


def test_train_cli_streams(tmp_path, capsys, monkeypatch):
    """--stream yes, and auto on a file over STREAM_MIN_BYTES, take the
    streamed plane; auto on a smaller file and no load the file."""
    tr = write_rows(tmp_path / "t.tsv", 5, 4)
    planes = {}
    for flags in (["--stream", "yes"], ["--stream", "no"], ["--stream",
                                                            "auto"]):
        args = cli.build_parser().parse_args([
            "train", "--train_file", tr, "--valid_file", tr, "--model_dir",
            str(tmp_path / "m"), "--device", "cpu", "--max_epoch_num", "1",
            "--min_epoch_num", "1", "--verbose_stages", *NARROW_FLAGS,
            *flags])
        planes[flags[1]] = port_train.train(args)["plane"]
        assert '"plane": "{}"'.format(planes[flags[1]]) in \
            capsys.readouterr().out
    assert planes == {"yes": "stream", "no": "resident", "auto": "resident"}
    monkeypatch.setattr(port_train, "STREAM_MIN_BYTES", 100)
    assert port_train.use_stream(args)
