"""The port's int8 wire (deepsignal_plant_tpu_torch) against the JAX
package's, on the CPU.

- The native quantizers (``dsp_quantize_i8_f16``, its portable loop, and
  ``dsp_quantize_i8_f32``) bitwise against the JAX library (built with
  -march=native, so its AVX-512 loop where the host has it) on ties at
  .5, NaN, inf, all-zero and empty arrays, float16 subnormals and
  lengths that are not a multiple of 16: the same int8 arrays and the
  same scales.
- ``quantize_for_wire`` (per-site batches) and ``quantize_packed`` (the
  read-packed base arrays) against JAX's quantization of the same
  arrays.
- call_mods at ``--transfer_dtype int8`` against JAX's at int8 on the TSV
  plane, on v1, v2 and v3 .npz batches and on the fused fast5 path
  (float32 compute, the plain recurrence): columns 1-6 and 10
  identical, both probabilities within 2e-6
  (tests/test_torch_call_mods.py's bound).
  JAX runs with ``packed_wire="force"`` so that, like the port, it
  quantizes every batch on the read-packed route (its per-site route for
  sparse blocks quantizes the windows instead, another scale).
- int8 against float16 in the port: agreement and max |dP1| are printed
  (-s); on random weights they are no gate.
- Without the native library int8 raises: there is no numpy quantizer.
"""
import os
import stat

import jax
import numpy as np
import pytest

from deepsignal_plant_tpu import cli as jax_cli
from deepsignal_plant_tpu.config import CallConfig as JaxCallConfig
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.models.bilstm import Batch as JaxBatch
from deepsignal_plant_tpu.models.bilstm import init_params as jax_init
from deepsignal_plant_tpu.models.convert import save_checkpoint
from deepsignal_plant_tpu.parallel.mesh import make_mesh
from deepsignal_plant_tpu.pipeline import call_mods as jax_call_mods
from deepsignal_plant_tpu.pipeline import extract as jax_extract
from deepsignal_plant_tpu.utils import fastparse as jfp
from deepsignal_plant_tpu_torch import cli, native
from deepsignal_plant_tpu_torch.models.bilstm import Batch
from deepsignal_plant_tpu_torch.pipeline import call_mods
from deepsignal_plant_tpu_torch.utils import fastparse as pfp
from make_synthetic import (synth_fast5_dir, synth_feature_rows,
                            synth_genome, write_feature_file)
from test_torch_call_mods import assert_rows_agree, read_rows

NARROW = dict(hidden_size=32, num_layers_comb=2)
NARROW_FLAGS = ["--hid_rnn", "32", "--layernum1", "2"]
F32 = ["--compute_dtype", "float32"]

needs_jax_lib = pytest.mark.skipif(
    jfp.get_native_lib() is None,
    reason="the JAX package's native library did not build here")


def _cases():
    rng = np.random.default_rng(23)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.5])
    return {
        "normal_1003": rng.normal(size=1003) * 4,
        "ties": np.tile(ties, 5),
        "nan": np.array([np.nan, 1.0, -2.0] * 7),
        "inf": np.array([np.inf, 1.0, -3.0] * 6),
        "zeros_17": np.zeros(17),
        "empty": np.zeros(0),
        "subnormal": np.array([6e-8, 1e-5, -6e-8, 3e-7, -1e-6] * 7),
        "len_33": rng.uniform(-500, 500, 33),
        "matrix": rng.normal(size=(61, 13, 16)),
    }


CASES = _cases()


@needs_jax_lib
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype,portable", [
    ("float16", False), ("float16", True), ("float32", False)],
    ids=["f16", "f16_portable", "f32"])
def test_quantizer_is_bitwise_the_jax_library(name, dtype, portable):
    a = CASES[name].astype(dtype)
    got, got_s = pfp.quantize_int8(a, portable=portable)
    want, want_s = jfp.quantize_int8(a)
    assert got.dtype == np.int8 and got.shape == a.shape
    np.testing.assert_array_equal(got, want)
    assert np.float32(got_s).tobytes() == np.float32(want_s).tobytes()
    if name in ("zeros_17", "empty"):
        assert got_s == 1.0
    if name == "nan":
        assert not got[::3].any()


def test_quantizer_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float16 or float32"):
        pfp.quantize_int8(np.zeros(4, np.float64))


def _f16_batch(n=300, seed=4, L=13, S=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, (n, L)).astype(np.int8),
            rng.normal(size=(n, L)).astype(np.float16),
            np.abs(rng.normal(size=(n, L))).astype(np.float16),
            rng.integers(1, 40, (n, L)).astype(np.float16),
            (rng.normal(size=(n, L, S)) * 2).astype(np.float16))


@needs_jax_lib
def test_quantize_for_wire_matches_jax():
    arrays = _f16_batch()
    got, got_s = call_mods.quantize_for_wire(Batch(*arrays))
    want, want_s = jax_call_mods.quantize_for_wire(JaxBatch(*arrays))
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got_s, want_s)
    assert got.base_signal_lens.dtype == np.float16


@needs_jax_lib
def test_quantize_packed_matches_jax_fields():
    """The read-packed batch's three float fields, each quantized on its
    own (JAX _predict_packed); codes, lens and centres pass through."""
    rng = np.random.default_rng(8)
    nb = 1000
    arrays = (rng.integers(0, 4, nb).astype(np.int8),
              rng.normal(size=nb).astype(np.float16),
              np.abs(rng.normal(size=nb)).astype(np.float16),
              rng.integers(1, 40, nb).astype(np.float16),
              rng.normal(size=(nb, 16)).astype(np.float16),
              np.arange(6, 900, 3, dtype=np.int32))
    got = call_mods.quantize_packed(arrays)
    for i in (0, 3, 5):
        assert got[i] is arrays[i]
    scales = []
    for i, j in ((1, 1), (2, 2), (4, 4)):
        q, s = jax_call_mods._quantize_field(arrays[j])
        np.testing.assert_array_equal(got[i], q)
        scales.append(s)
    np.testing.assert_array_equal(got[6], np.array(scales, np.float32))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxModelConfig(**NARROW)
    path = str(tmp_path_factory.mktemp("ckpt") / "narrow.ckpt.npz")
    save_checkpoint(path, jax_init(jax.random.PRNGKey(21), cfg), cfg)
    return path


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    rows = synth_feature_rows(np.random.default_rng(41), n_reads=11,
                              sites_per_read=25)
    path = str(tmp_path_factory.mktemp("feat") / "features.tsv")
    return write_feature_file(path, rows)


def _jax_engine(ckpt, transfer="int8", device_batch=200):
    cfg = JaxModelConfig(recurrence="scan", compute_dtype="float32",
                         dropout_rate=0.0, **NARROW)
    return jax_call_mods.CallModsEngine(
        ckpt, cfg, JaxCallConfig(transfer_dtype=transfer,
                                 device_batch=device_batch,
                                 packed_wire="force"),
        mesh=make_mesh(jax.devices()[:1]))


def _port(inp, ckpt, out, *extra):
    cli.main(["call_mods", "-i", inp, "-m", ckpt, "-o", str(out),
              "--device", "cpu", *NARROW_FLAGS, *F32, *extra])
    return read_rows(str(out))


def _save_container(plane, path, data):
    from deepsignal_plant_tpu_torch.utils.fastparse import (
        pack_raw_block, parse_feature_bytes, parse_raw_feature_block)
    from deepsignal_plant_tpu_torch.utils.formats import (
        save_feature_npz, save_packed_npz, save_wire_npz)
    if plane == "v3":
        save_packed_npz(path, pack_raw_block(parse_raw_feature_block(data)))
    else:
        (save_feature_npz if plane == "v1" else save_wire_npz)(
            path, parse_feature_bytes(data))


@needs_jax_lib
@pytest.mark.parametrize("plane", ["tsv", "v1", "v2", "v3"])
def test_int8_call_mods_matches_jax(ckpt, features, tmp_path, plane):
    """Batches of 200 sites, each with its own scales, on both sides: the
    port quantizes the read-packed base axis (TSV, v2 repacked, v3) or
    the per-site windows (v1); JAX quantizes v1 and v2 as per-site
    windows, v2's repacked axis holding just those window values."""
    inp = features
    if plane != "tsv":
        inp = str(tmp_path / plane)
        os.makedirs(inp)
        with open(features, "rb") as fh:
            data = fh.read()
        cut = data.index(b"\n", len(data) // 2) + 1
        for i, part in enumerate((data[:cut], data[cut:])):
            _save_container(plane, os.path.join(inp, f"{i:06d}.npz"), part)
    want_path = str(tmp_path / "jax.tsv")
    _jax_engine(ckpt).run_features_file(inp, want_path)
    got = _port(inp, ckpt, tmp_path / "port.tsv", "--transfer_dtype",
                "int8", "--device_batch", "200")
    want = read_rows(want_path)
    assert len(got) == 275
    assert_rows_agree(got, want)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """10 reads in two fast5 batches of 5."""
    tmp = tmp_path_factory.mktemp("fused_int8")
    rng = np.random.default_rng(43)
    genome = synth_genome(rng, {"chr1": 5000, "chr2": 4000})
    synth_fast5_dir(str(tmp / "f5"), genome, rng, n_reads=10, read_len=500,
                    max_event_len=25, meth_mode="mixed")
    return str(tmp / "f5")


@needs_jax_lib
def test_int8_fused_fast5_matches_jax(run, ckpt, tmp_path):
    """Two extraction workers on both sides; one device batch holds every
    site, so the scales do not depend on which worker finishes first."""
    got = sorted(_port(run, ckpt, tmp_path / "port.tsv", "--transfer_dtype",
                       "int8", "--nproc", "2", "--f5_batch_size", "5"))
    args = jax_cli.build_parser().parse_args(
        ["call_mods", "-i", run, "-m", ckpt, "-o", str(tmp_path / "j.tsv"),
         "--f5_batch_size", "5", "--nproc", "2", "--transfer_dtype",
         "int8"])
    eng = _jax_engine(ckpt, device_batch=32768)
    jax_extract.extract_to_call_mods(eng, run, args, str(tmp_path / "j.tsv"))
    want = sorted(read_rows(str(tmp_path / "j.tsv")))
    assert len(got) > 200
    assert_rows_agree(got, want)


def test_int8_against_float16_is_reported(ckpt, features, tmp_path):
    """The port's int8 wire against its float16 wire on the same TSV:
    the same rows and k-mers; agreement and max |dP1| printed (random
    weights: no gate)."""
    f16 = _port(features, ckpt, tmp_path / "f16.tsv")
    i8 = _port(features, ckpt, tmp_path / "i8.tsv", "--transfer_dtype",
               "int8")
    assert [r[:6] + r[9:] for r in i8] == [r[:6] + r[9:] for r in f16]
    p16 = np.array([float(r[7]) for r in f16])
    p8 = np.array([float(r[7]) for r in i8])
    assert np.isfinite(p8).all() and ((p8 >= 0) & (p8 <= 1)).all()
    agree = float(np.mean([a[8] == b[8] for a, b in zip(i8, f16)]))
    print(f"int8 vs float16, {len(f16)} sites, random weights: agreement "
          f"{agree:.4f}, max|dP1| {np.abs(p8 - p16).max():.3g}")


def test_int8_without_the_native_library_raises(tmp_path, monkeypatch):
    """A compiler that fails: the quantizer raises instead of quantizing
    in numpy."""
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "CXX", str(script))
    with pytest.raises(RuntimeError, match="no compiler here"):
        call_mods.quantize_packed((np.zeros(4, np.int8),) + tuple(
            np.zeros(4, np.float16) for _ in range(4))
            + (np.zeros(1, np.int32),))
