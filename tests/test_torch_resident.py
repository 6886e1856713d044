"""``call_mods --device_resident always`` and ``--profile_dir`` in the port
(deepsignal_plant_tpu_torch), on the CPU at a narrow width.

- The resident plane groups the streaming plane's batches into segments
  (one upload and one readback a segment), so its bytes equal the
  streaming plane's at the same ``--device_batch``: on a features TSV
  (float16, int8 and float32 wires), v2 .npz batches (per-site, float16)
  and v3 batches (float16 and int8), and on a run of several segments
  (the JAX package's gate, tests/test_resident_call.py).
- Against the JAX package's resident engine on the same TSV and v3
  batches (float32 compute, the plain recurrence): columns 1-6 and 10
  identical, probabilities within 2e-6.
- JAX's resident float32 wire on a TSV is float16 (a fault of the JAX
  package the port does not copy): the test prints the gap.
- v1 .npz batches and gzipped TSVs raise JAX's messages, before any
  output is opened.
- ``--profile_dir`` writes a torch.profiler trace (CPU activity here)
  holding the engine's stage ranges.
"""
import glob
import gzip
import json
import os

import jax
import numpy as np
import pytest

from deepsignal_plant_tpu import cli as jax_cli
from deepsignal_plant_tpu.config import CallConfig as JaxCallConfig
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.models.bilstm import init_params as jax_init
from deepsignal_plant_tpu.models.convert import save_checkpoint
from deepsignal_plant_tpu.parallel.mesh import make_mesh
from deepsignal_plant_tpu.pipeline.call_mods import \
    CallModsEngine as JaxEngine
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import CallConfig, ModelConfig
from deepsignal_plant_tpu_torch.pipeline import call_mods
from make_synthetic import (synth_fast5_dir, synth_feature_rows,
                            synth_genome, write_feature_file)
from test_torch_call_mods import assert_rows_agree, read_rows

NARROW = dict(hidden_size=32, num_layers_comb=2)
NARROW_FLAGS = ["--hid_rnn", "32", "--layernum1", "2"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A read-structured TSV (12 reads x 20 sites) and a fast5 run
    extracted into v1, v2 and v3 batches."""
    tmp = tmp_path_factory.mktemp("resident")
    rng = np.random.default_rng(71)
    out = {"tsv": write_feature_file(
        str(tmp / "f.tsv"), synth_feature_rows(rng, n_reads=12,
                                               sites_per_read=20))}
    genome = synth_genome(rng, {"chr1": 4000, "chr2": 3000})
    synth_fast5_dir(str(tmp / "f5"), genome, rng, n_reads=8, read_len=500,
                    max_event_len=25, meth_mode="mixed")
    for fmt, key in (("npz", "v1"), ("npz_wire", "v2"),
                     ("npz_packed", "v3")):
        jax_cli.main(["extract", "-i", str(tmp / "f5"), "-o",
                      str(tmp / key), "--w_format", fmt, "--nproc", "1",
                      "--f5_batch_size", "3"])
        out[key] = str(tmp / key)
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxModelConfig(**NARROW)
    path = str(tmp_path_factory.mktemp("ckpt") / "narrow.ckpt.npz")
    save_checkpoint(path, jax_init(jax.random.PRNGKey(19), cfg), cfg)
    return path


def _engine(ckpt, wire, resident, device_batch=64):
    cfg = ModelConfig(compute_dtype="float32", dropout_rate=0.0, **NARROW)
    return call_mods.CallModsEngine(ckpt, cfg, CallConfig(
        device_batch=device_batch, transfer_dtype=wire,
        device_resident=resident), "cpu")


@pytest.mark.parametrize("inp,wire", [
    ("tsv", "float16"), ("tsv", "int8"), ("tsv", "float32"),
    ("v2", "float16"), ("v3", "float16"), ("v3", "int8")])
def test_resident_bytes_equal_the_streaming_plane(inputs, ckpt, tmp_path,
                                                  inp, wire):
    got = {}
    for plane in ("never", "always"):
        out = str(tmp_path / f"{plane}.tsv")
        st = _engine(ckpt, wire, plane).run_features_file(inputs[inp], out)
        got[plane] = (open(out, "rb").read(), st)
    (stream, s_st), (res, r_st) = got["never"], got["always"]
    assert res == stream and len(res.splitlines()) == s_st.sites > 150
    assert r_st.batches == s_st.batches and r_st.resident_segments == 1
    # one segment covers the estimated rows (.npz: the first file's
    # sites times the files)
    assert r_st.resident_k_chunks >= s_st.batches
    assert s_st.resident_segments is None
    if inp == "v2":       # per-site at the float16 wire, as JAX
        assert r_st.persite_sites == r_st.sites
        assert s_st.packed_sites == s_st.sites


def test_resident_run_of_several_segments(inputs, ckpt, tmp_path,
                                          monkeypatch):
    """At most 2 batches of 32 rows a segment: 240 rows in 8 batches, 4
    segments, the streaming plane's bytes."""
    monkeypatch.setattr(call_mods, "RESIDENT_MAX_CHUNKS", 2)
    outs = {}
    for plane in ("never", "always"):
        out = str(tmp_path / f"{plane}.tsv")
        st = _engine(ckpt, "float16", plane, 32).run_features_file(
            inputs["tsv"], out)
        outs[plane] = open(out, "rb").read()
    assert st.sites == 240 and st.batches == 8
    assert (st.resident_k_chunks, st.resident_segments) == (2, 4)
    assert outs["always"] == outs["never"]


def _jax_resident(ckpt, inp, out, wire="float16", resident="always"):
    cfg = JaxModelConfig(recurrence="scan", compute_dtype="float32",
                         dropout_rate=0.0, **NARROW)
    JaxEngine(ckpt, cfg, JaxCallConfig(transfer_dtype=wire,
                                       device_batch=64,
                                       device_resident=resident),
              mesh=make_mesh(jax.devices()[:1])).run_features_file(inp, out)
    return read_rows(out)


@pytest.mark.parametrize("inp", ["tsv", "v3"])
def test_resident_matches_jax_resident(inputs, ckpt, tmp_path, inp):
    want = _jax_resident(ckpt, inputs[inp], str(tmp_path / "jax.tsv"))
    cli.main(["call_mods", "-i", inputs[inp], "-m", ckpt, "-o",
              str(tmp_path / "port.tsv"), "--device", "cpu",
              "--compute_dtype", "float32", "--device_batch", "64",
              "--device_resident", "always", *NARROW_FLAGS])
    assert_rows_agree(read_rows(str(tmp_path / "port.tsv")), want)


def test_float32_resident_fault_of_jax_is_not_ported(inputs, ckpt, tmp_path,
                                                     capsys):
    """JAX's resident plane parses a TSV into the float16 read-packed
    wire whatever --transfer_dtype says (its call_mods.py:1779-1795), so
    its resident float32 calls are its float16 calls. The port's
    resident float32 plane sends per-site float32 batches: it agrees with
    JAX's streaming float32 calls within 2e-6. The gap JAX's resident
    float32 leaves against its own streaming float32 is printed (-s)."""
    tsv = inputs["tsv"]
    j_res = _jax_resident(ckpt, tsv, str(tmp_path / "j_res.tsv"),
                          "float32")
    j_f16 = _jax_resident(ckpt, tsv, str(tmp_path / "j_f16.tsv"))
    j_f32 = _jax_resident(ckpt, tsv, str(tmp_path / "j_f32.tsv"),
                          "float32", "never")
    assert j_res == j_f16
    cli.main(["call_mods", "-i", tsv, "-m", ckpt, "-o",
              str(tmp_path / "port.tsv"), "--device", "cpu",
              "--compute_dtype", "float32", "--transfer_dtype", "float32",
              "--device_batch", "64", "--device_resident", "always",
              *NARROW_FLAGS])
    port = read_rows(str(tmp_path / "port.tsv"))
    assert_rows_agree(port, j_f32)
    diff = sum(a != b for a, b in zip(j_res, j_f32))
    dp = max(abs(float(a[7]) - float(b[7])) for a, b in zip(j_res, j_f32))
    dp_port = max(abs(float(a[7]) - float(b[7]))
                  for a, b in zip(port, j_f32))
    assert [r[:6] for r in j_res] == [r[:6] for r in j_f32]
    with capsys.disabled():
        print(f"\nJAX resident float32 (a float16 wire) vs JAX streaming "
              f"float32 on a TSV: {diff} of {len(j_f32)} rows differ, max "
              f"|dP1| {dp:.3g}; the port's resident float32 vs JAX "
              f"streaming float32: max |dP1| {dp_port:.3g}")


def test_resident_refuses_v1_and_gzip(inputs, ckpt, tmp_path):
    gz = str(tmp_path / "f.tsv.gz")
    with open(inputs["tsv"], "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    eng = _engine(ckpt, "float16", "always")
    for inp, match in ((inputs["v1"], "does not serve v1 .npz features"),
                       (gz, "plain features TSV or wire-format .npz")):
        out = tmp_path / "o.tsv"
        with pytest.raises(ValueError, match=match):
            eng.run_features_file(inp, str(out))
        assert not out.exists()


def test_profile_dir_writes_a_trace(inputs, ckpt, tmp_path, capsys):
    prof = tmp_path / "prof"
    cli.main(["call_mods", "-i", inputs["v3"], "-m", ckpt, "-o",
              str(tmp_path / "o.tsv"), "--device", "cpu", "--profile_dir",
              str(prof), *NARROW_FLAGS])
    traces = glob.glob(str(prof / "call_mods-*.trace.json"))
    assert len(traces) == 1
    assert f"[prof] device trace written to {traces[0]}" in \
        capsys.readouterr().out
    with open(traces[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"upload", "forward", "readback", "emit"} <= names
    assert os.path.getsize(tmp_path / "o.tsv") > 0
