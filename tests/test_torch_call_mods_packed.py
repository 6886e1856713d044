"""The port's call_mods on the float16 plane (native parser, read-packed
route, native row emission) and the float32 plane (per-site route) on a
read-structured features TSV, on the CPU.

Gates:
- the output bytes do not depend on --packed_wire (auto, off, force: all
  take the read-packed route), on --device_batch or on how the parser
  cuts the file into blocks; with the rows shuffled, the same rows come
  out in the shuffled order;
- against the JAX engine's native TSV plane (_run_fast_tsv) on a
  one-device CPU mesh at the same float16 wire: columns 1-6 and 10
  identical, both probabilities within 2e-6 (one 6-decimal rounding
  step on either side), as in tests/test_torch_call_mods.py.
"""
import threading

import jax
import numpy as np
import pytest

from deepsignal_plant_tpu.config import CallConfig as JaxCallConfig
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.parallel.mesh import make_mesh
from deepsignal_plant_tpu.pipeline.call_mods import \
    CallModsEngine as JaxEngine
from deepsignal_plant_tpu_torch import native
from deepsignal_plant_tpu_torch.config import CallConfig, ModelConfig
from deepsignal_plant_tpu_torch.io import batching
from deepsignal_plant_tpu_torch.pipeline import call_mods as port_call_mods
from test_torch_call_mods import (NARROW, assert_rows_agree, ckpt,  # noqa
                                  read_rows, run_port)
from test_torch_fastparse import read_structured_rows

batching_iter_byte_blocks = batching.iter_byte_blocks


@pytest.fixture(scope="module")
def tsvs(tmp_path_factory):
    """The dense extraction (12 reads) in extraction order and shuffled."""
    tmp = tmp_path_factory.mktemp("dense")
    rows = read_structured_rows(str(tmp), n_reads=12)
    order = np.random.default_rng(9).permutation(len(rows))
    out = {}
    for name, rs in (("sorted", rows), ("shuffled", [rows[i] for i in order])):
        path = tmp / f"{name}.tsv"
        path.write_text("\n".join(rs) + "\n")
        out[name] = str(path)
    return out, order


def engine(ckpt, **call):
    cfg = ModelConfig(compute_dtype="float32", dropout_rate=0.0, **NARROW)
    return port_call_mods.CallModsEngine(ckpt, cfg, CallConfig(**call),
                                         "cpu")


def run(ckpt, path, out, **call):
    stats = engine(ckpt, **call).run_features_file(path, str(out))
    with open(out, "rb") as fh:
        return fh.read(), stats


@pytest.mark.parametrize("name", ["sorted", "shuffled"])
def test_packed_wire_choices_write_the_same_bytes(ckpt, tsvs, tmp_path,
                                                  name):
    """auto, off and force give one output, all through the packed route
    (the route counters); rows in extraction order share their window
    bases (~1/3 of the per-site bytes), shuffled rows hardly any."""
    path = tsvs[0][name]
    outs = {w: run(ckpt, path, tmp_path / f"{w}.tsv", packed_wire=w)
            for w in ("auto", "off", "force")}
    n = outs["auto"][1].sites
    assert n > 300
    for w, (data, st) in outs.items():
        assert data == outs["auto"][0], w
        assert (st.packed_sites, st.packed_batches, st.persite_sites) == (
            n, 1, 0)
    st = outs["auto"][1]
    persite_bytes = n * 13 * (1 + 2 * 3 + 2 * 16)
    if name == "sorted":
        assert st.bases_uploaded < n * 13 / 2
        assert st.wire_bytes < persite_bytes / 2
    else:
        assert st.bases_uploaded > n * 12
        assert st.wire_bytes == st.bases_uploaded * 39 + n * 4


def test_shuffled_rows_give_the_same_rows(ckpt, tsvs, tmp_path):
    (paths, order) = tsvs
    a, _ = run(ckpt, paths["sorted"], tmp_path / "a.tsv")
    b, _ = run(ckpt, paths["shuffled"], tmp_path / "b.tsv")
    rows_a = a.decode().splitlines()
    assert b.decode().splitlines() == [rows_a[i] for i in order]


@pytest.mark.parametrize("wire", ["float16", "float32"])
def test_batch_width_and_blocks_do_not_change_the_bytes(
        ckpt, tsvs, tmp_path, monkeypatch, wire):
    """The default device batch (one batch here) against 64-site batches,
    and against 64-site batches cut from ~30 KB parse blocks (batches and
    packed spans cross block edges), on either wire."""
    path = tsvs[0]["sorted"]
    one, st1 = run(ckpt, path, tmp_path / "one.tsv", transfer_dtype=wire)
    assert st1.device_batch == CallConfig.device_batch == 32768
    assert st1.batches == 1
    small, st64 = run(ckpt, path, tmp_path / "small.tsv", device_batch=64,
                      transfer_dtype=wire)
    assert st64.batches == -(-st64.sites // 64)
    monkeypatch.setattr(port_call_mods, "iter_byte_blocks",
                        lambda p, _: batching_iter_byte_blocks(p, 30_000))
    monkeypatch.setattr(batching, "iter_byte_blocks",
                        lambda p, _: batching_iter_byte_blocks(p, 30_000))
    cut, stc = run(ckpt, path, tmp_path / "cut.tsv", device_batch=64,
                   transfer_dtype=wire, num_parse_workers=3)
    assert small == one and cut == one
    assert stc.sites == st1.sites
    assert (stc.parse_seconds > 0) if wire == "float16" else (
        stc.parse_seconds is None and stc.persite_sites == stc.sites)


def test_cli_matches_the_jax_native_tsv_plane(ckpt, tsvs, tmp_path):
    """The CLI (float16 wire, the packed route) against the JAX engine's
    _run_fast_tsv at float16 wire, scan recurrence, float32 compute."""
    path = tsvs[0]["sorted"]
    jcfg = JaxModelConfig(recurrence="scan", compute_dtype="float32",
                          dropout_rate=0.0, **NARROW)
    eng = JaxEngine(ckpt, jcfg, JaxCallConfig(transfer_dtype="float16"),
                    mesh=make_mesh(jax.devices()[:1]))
    want_path = str(tmp_path / "jax.tsv")
    eng._run_fast_tsv(path, want_path, False, 2048)
    got = run_port(path, ckpt, str(tmp_path / "port.tsv"),
                   "--compute_dtype", "float32", "--packed_wire", "auto")
    assert len(got) > 300
    assert_rows_agree(got, read_rows(want_path))


def test_empty_input_writes_an_empty_file(ckpt, tmp_path):
    path = tmp_path / "empty.tsv"
    path.write_text("")
    data, st = run(ckpt, str(path), tmp_path / "out.tsv")
    assert data == b"" and st.sites == st.batches == 0


@pytest.mark.parametrize("wire", ["float16", "float32"])
def test_a_failed_write_leaves_no_thread_running(ckpt, tsvs, tmp_path,
                                                 monkeypatch, wire):
    """A writer that fails on its first block fails the run, and the
    parser threads, the prefetch thread and the writer thread all end
    (the parse queues were full: ~30 KB blocks, 64-site batches)."""
    class FailingWriter(batching.AsyncWriter):
        def write(self, block):
            raise OSError("disk full")

    monkeypatch.setattr(port_call_mods, "AsyncWriter", FailingWriter)
    monkeypatch.setattr(port_call_mods, "iter_byte_blocks",
                        lambda p, _: batching.iter_byte_blocks(p, 30_000))
    monkeypatch.setattr(batching, "iter_byte_blocks",
                        lambda p, _: batching_iter_byte_blocks(p, 30_000))
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="disk full"):
        run(ckpt, tsvs[0]["sorted"], tmp_path / "x.tsv", device_batch=64,
            transfer_dtype=wire, num_parse_workers=3)
    assert [t for t in threading.enumerate() if t not in before] == []


def test_failed_native_build_fails_call_mods(ckpt, tsvs, tmp_path,
                                             monkeypatch):
    """With a compiler that fails, call_mods raises with the compiler's
    command; it does not parse in Python instead."""
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="false build of featparse.cpp "
                                           "failed"):
        run_port(tsvs[0]["sorted"], ckpt, str(tmp_path / "x.tsv"))
