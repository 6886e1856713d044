"""The port's .npz feature planes (deepsignal_plant_tpu_torch) against the
JAX package's, on the CPU at a narrow width (hidden 32, 2 comb layers).

- The containers: v1 (``save_feature_npz``), v2 (``save_wire_npz``) and
  v3 (``save_packed_npz``) written by either package load in the other's
  loader with equal arrays; the raw zip reader, the version probes and
  the directory listing agree.
- ``extract --w_format npz|npz_wire|npz_packed``: the same files with the
  same arrays as JAX extract's (compared array by array: ``np.savez``
  stamps zip member times, so the bytes never repeat), at ``--nproc`` 1
  and 2, with the ``even`` downsampling and with ``compat --seed``.
  A pooled worker killed inside its save leaves no .npz and no temp;
  one that dies once is replaced and nothing is lost.
- call_mods on directories of v1, v2 and v3 batches and on one .npz
  file, at the float16 and float32 wires: columns 1-6 and 10 identical
  to JAX call_mods on the same files, both probabilities within 2e-6
  (tests/test_torch_call_mods.py). A directory mixing versions raises.
- train on a v1 .npz directory written from the TSV's parsed rows takes
  the steps of train on that TSV (equal losses and weights), in both
  data planes; v2 and v3 directories raise JAX's message.
- serve picks up .npz drops; the served bytes equal the CLI's.
"""
import os
import shutil
import signal

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
from deepsignal_plant_tpu.utils import fastparse as jfp
from deepsignal_plant_tpu.utils import formats as jfm
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.pipeline import extract
from deepsignal_plant_tpu_torch.pipeline import train as port_train
from deepsignal_plant_tpu_torch.utils import fastparse as pfp
from deepsignal_plant_tpu_torch.utils import formats as pfm
from make_synthetic import (synth_fast5_dir, synth_feature_rows,
                            synth_genome, write_feature_file)
from test_torch_call_mods import assert_rows_agree, read_rows

NARROW = dict(hidden_size=32, num_layers_comb=2)
NARROW_FLAGS = ["--hid_rnn", "32", "--layernum1", "2"]
FORMATS = ("npz", "npz_wire", "npz_packed")
VERSION = {"npz": 0, "npz_wire": 2, "npz_packed": 3}


@pytest.fixture(scope="module")
def tsv_bytes(tmp_path_factory):
    rows = synth_feature_rows(np.random.default_rng(51), n_reads=6,
                              sites_per_read=20)
    path = write_feature_file(
        str(tmp_path_factory.mktemp("rows") / "f.tsv"), rows)
    with open(path, "rb") as fh:
        return fh.read()


def _arrays(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


FB = ("kmer", "base_means", "base_stds", "base_signal_lens", "signals",
      "labels")
RB = ("row_starts", "info_ends", "kmer", "means", "stds", "slens",
      "signals", "labels")
PB = ("row_starts", "info_ends", "centers", "codes", "means", "stds",
      "lens", "rect", "labels")


def _write(side, fmt, path, data):
    """One container of ``data``'s rows written by ``side``'s package."""
    fp, fm = (pfp, pfm) if side == "port" else (jfp, jfm)
    if fmt == "npz":
        fm.save_feature_npz(path, fp.parse_feature_bytes(data))
    elif fmt == "npz_wire":
        fm.save_wire_npz(path, fp.parse_feature_bytes(data))
    else:
        fm.save_packed_npz(path, fp.pack_raw_block(
            fp.parse_raw_feature_block(data)))


def _load(side, fmt, path):
    fm = pfm if side == "port" else jfm
    if fmt == "npz":
        fb = fm.load_feature_npz(path)
        return fb.sampleinfo, _arrays(fb, FB)
    if fmt == "npz_wire":
        rb = fm.load_wire_npz(path)
        return rb.raw, _arrays(rb, RB)
    pb = fm.load_packed_npz(path)
    return (pb.raw, pb.kmer_len), _arrays(pb, PB)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")],
                         ids=["port_writes", "jax_writes"])
def test_container_loads_in_the_other_package(tsv_bytes, tmp_path, fmt,
                                              writer, reader):
    path = str(tmp_path / "b.npz")
    _write(writer, fmt, path, tsv_bytes)
    got_meta, got = _load(reader, fmt, path)
    want_meta, want = _load(writer, fmt, path)
    assert got_meta == want_meta
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    raw_p, raw_j = pfm._read_npz_arrays(path), jfm._read_npz_arrays(path)
    assert sorted(raw_p) == sorted(raw_j)
    for k in raw_j:
        np.testing.assert_array_equal(raw_p[k], raw_j[k])
    assert pfm.wire_npz_version(path) == jfm.wire_npz_version(path) \
        == VERSION[fmt]
    assert pfm.is_wire_npz(path) == jfm.is_wire_npz(path) == (fmt != "npz")
    assert pfm.feature_npz_paths(str(tmp_path)) == \
        jfm.feature_npz_paths(str(tmp_path)) == [path]
    assert pfm.feature_npz_paths(path) == [path]


def test_wire_containers_are_refused_where_v1_is_needed(tsv_bytes,
                                                        tmp_path):
    for fmt in ("npz_wire", "npz_packed"):
        path = str(tmp_path / f"{fmt}.npz")
        _write("port", fmt, path, tsv_bytes)
        with pytest.raises(ValueError, match=r"wire-format \(v\d\) "
                           "inference container"):
            pfm.load_feature_npz(path)
    with pytest.raises(ValueError, match="not v3"):
        pfm.load_packed_npz(str(tmp_path / "npz_wire.npz"))
    with pytest.raises(ValueError, match="not v2"):
        pfm.load_wire_npz(str(tmp_path / "npz_packed.npz"))


# --- extract ----------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """12 reads of 500 bases in three fast5 batches of 4, events up to 24
    samples (above signal_len, for the downsampling)."""
    tmp = tmp_path_factory.mktemp("npz_run")
    rng = np.random.default_rng(53)
    genome = synth_genome(rng, {"chr1": 4000, "chr2": 3000})
    synth_fast5_dir(str(tmp / "f5"), genome, rng, n_reads=12, read_len=500,
                    max_event_len=25, meth_mode="mixed")
    return str(tmp / "f5")


def _extract(main, run, out, fmt, nproc, extra=()):
    main(["extract", "-i", run, "-o", str(out), "--w_format", fmt,
          "--nproc", str(nproc), "--f5_batch_size", "4", *extra])
    return {f: pfm._read_npz_arrays(os.path.join(out, f))
            for f in sorted(os.listdir(out))}


def _assert_same_files(got, want):
    assert sorted(got) == sorted(want) and want
    for f in want:
        assert sorted(got[f]) == sorted(want[f]), f
        for k in want[f]:
            assert got[f][k].dtype == want[f][k].dtype, (f, k)
            np.testing.assert_array_equal(got[f][k], want[f][k],
                                          err_msg=f"{f}:{k}")


@pytest.mark.parametrize("seeded", [False, True], ids=["even", "compat_seed"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_extract_npz_matches_jax_at_every_nproc(run, tmp_path, fmt, seeded):
    extra = ("--downsample", "compat", "--seed", "7") if seeded else ()
    want = _extract(jax_cli.main, run, tmp_path / "jax", fmt, 1, extra)
    assert len(want) == 3
    for nproc in (1, 2):
        got = _extract(cli.main, run, tmp_path / f"port{nproc}", fmt, nproc,
                       extra)
        _assert_same_files(got, want)


def crash_in_save(paths, batch_idx=0):
    """Kill this worker halfway through saving a batch that holds a
    ``*crashme*`` file: the saver writes a zip header, flushes and dies."""
    if any("crashme" in os.path.basename(p) for p in paths):
        def half_then_die(fh, blk):
            fh.write(b"PK\x03\x04" + b"\0" * 64)
            fh.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        extract.NPZ_SAVERS[extract._G_SINK[1]] = half_then_die
    return extract._worker_batch_save(paths, batch_idx)


def crash_once_in_save(paths, batch_idx=0):
    """crash_in_save the first time a ``*crashme*`` batch runs (a sentinel
    beside the fast5s records it); later attempts save normally."""
    if any("crashme" in os.path.basename(p) for p in paths):
        sentinel = os.path.join(os.path.dirname(paths[0]), ".crashed")
        try:
            os.close(os.open(sentinel, os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            return extract._worker_batch_save(paths, batch_idx)
        return crash_in_save(paths, batch_idx)
    return extract._worker_batch_save(paths, batch_idx)


@pytest.fixture
def crash_run(run, tmp_path):
    d = tmp_path / "f5"
    shutil.copytree(run, d)
    os.replace(d / "synthread_005.fast5", d / "synthread_005_crashme.fast5")
    return d


def _pool_extract(d, out, fmt, nproc):
    ctx = extract.ExtractContext.build(extract.ExtractOptions())
    return extract.extract_features(str(d), False, ctx, str(out),
                                    nproc=nproc, f5_batch_size=4,
                                    out_format=fmt)


def test_killed_npz_worker_leaves_no_npz(crash_run, tmp_path, monkeypatch,
                                         capsys, fmt="npz_packed"):
    """Every attempt at the crashme batch dies inside its save: the batch
    is quarantined (its 4 files counted as failed), no .npz or temp of it
    is left, and the other batches hold the single-process arrays. (The
    three formats share the save path; the next test takes v1.)"""
    assert _pool_extract(crash_run, tmp_path / "one", fmt, 1) == (12, 0)
    monkeypatch.setattr(extract, "_worker_batch_save", crash_in_save)
    assert _pool_extract(crash_run, tmp_path / "pool", fmt, 2) == (12, 4)
    assert "kills its worker — quarantined (4 files" in \
        capsys.readouterr().out
    files = extract.get_fast5s(str(crash_run), False)
    bad = next(i for i in range(3)
               if any("crashme" in p for p in files[4 * i:4 * i + 4]))
    left = sorted(os.listdir(tmp_path / "pool"))
    assert left == [f"{i:06d}.npz" for i in range(3) if i != bad]
    for f in left:
        got = pfm._read_npz_arrays(str(tmp_path / "pool" / f))
        want = pfm._read_npz_arrays(str(tmp_path / "one" / f))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_npz_worker_that_dies_once_is_replaced(crash_run, tmp_path,
                                               monkeypatch):
    _pool_extract(crash_run, tmp_path / "one", "npz", 1)
    monkeypatch.setattr(extract, "_worker_batch_save", crash_once_in_save)
    assert _pool_extract(crash_run, tmp_path / "pool", "npz", 2) \
        == (12, 0)
    assert (crash_run / ".crashed").exists()
    read = {f: pfm._read_npz_arrays(str(tmp_path / "pool" / f))
            for f in os.listdir(tmp_path / "pool")}
    _assert_same_files(read, {
        f: pfm._read_npz_arrays(str(tmp_path / "one" / f))
        for f in os.listdir(tmp_path / "one")})


# --- call_mods --------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxModelConfig(**NARROW)
    path = str(tmp_path_factory.mktemp("ckpt") / "narrow.ckpt.npz")
    save_checkpoint(path, jax_init(jax.random.PRNGKey(17), cfg), cfg)
    return path


@pytest.fixture(scope="module")
def npz_dirs(run, tmp_path_factory):
    """The fast5 run extracted by JAX into each container."""
    tmp = tmp_path_factory.mktemp("npz_dirs")
    out = {}
    for fmt in FORMATS:
        d = tmp / fmt
        jax_cli.main(["extract", "-i", run, "-o", str(d), "--w_format", fmt,
                      "--nproc", "1", "--f5_batch_size", "4"])
        out[fmt] = str(d)
    return out


def _jax_calls(ckpt, inp, out, transfer):
    cfg = JaxModelConfig(recurrence="scan", compute_dtype="float32",
                         dropout_rate=0.0, **NARROW)
    JaxEngine(ckpt, cfg, JaxCallConfig(transfer_dtype=transfer,
                                       device_batch=256),
              mesh=make_mesh(jax.devices()[:1])).run_features_file(inp, out)
    return read_rows(out)


def _port_calls(ckpt, inp, out, *extra):
    cli.main(["call_mods", "-i", inp, "-m", ckpt, "-o", str(out),
              "--device", "cpu", "--compute_dtype", "float32",
              "--device_batch", "256", *NARROW_FLAGS, *extra])
    return read_rows(str(out))


@pytest.mark.parametrize("transfer", ["float16", "float32"])
@pytest.mark.parametrize("what", ["dir", "file"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_call_mods_on_npz_matches_jax(npz_dirs, ckpt, tmp_path, capsys, fmt,
                                      what, transfer):
    inp = npz_dirs[fmt]
    if what == "file":
        inp = os.path.join(inp, "000001.npz")
    want = _jax_calls(ckpt, inp, str(tmp_path / "jax.tsv"), transfer)
    capsys.readouterr()
    got = _port_calls(ckpt, inp, tmp_path / "port.tsv", "--transfer_dtype",
                      transfer)
    assert len(got) > (80 if what == "file" else 300)
    assert_rows_agree(got, want)
    assert ("[warn] v1 .npz feature batches are DEPRECATED" in
            capsys.readouterr().out) == (fmt == "npz")


def test_npz_planes_give_the_rows_of_the_tsv_plane(run, npz_dirs, ckpt,
                                                   tmp_path):
    """At the float16 wire every container gives the bytes of call_mods
    on the TSV extracted from the same run (v1's per-site route
    included: the same float16 windows into the same forward)."""
    tsv = str(tmp_path / "f.tsv")
    cli.main(["extract", "-i", run, "-o", tsv, "--nproc", "1"])
    _port_calls(ckpt, tsv, tmp_path / "tsv.out")
    want = open(tmp_path / "tsv.out", "rb").read()
    for fmt in FORMATS:
        _port_calls(ckpt, npz_dirs[fmt], tmp_path / f"{fmt}.out")
        assert open(tmp_path / f"{fmt}.out", "rb").read() == want, fmt


def test_mixed_versions_raise(npz_dirs, ckpt, tmp_path):
    d = tmp_path / "mixed"
    d.mkdir()
    shutil.copy(os.path.join(npz_dirs["npz_packed"], "000000.npz"),
                d / "000000.npz")
    shutil.copy(os.path.join(npz_dirs["npz_wire"], "000001.npz"),
                d / "000001.npz")
    with pytest.raises(ValueError, match="must not mix wire versions"):
        _port_calls(ckpt, str(d), tmp_path / "o.tsv")
    assert not (tmp_path / "o.tsv").exists()


# --- train ------------------------------------------------------------

def _train_args(tmp_path, tr, va, name, plane):
    return cli.build_parser().parse_args([
        "train", "--train_file", tr, "--valid_file", va, "--model_dir",
        str(tmp_path / name), "--device", "cpu", "--dropout_rate", "0",
        "--batch_size", "64", "--lr", "0.05", "--max_epoch_num", "2",
        "--min_epoch_num", "2", "--step_interval", "3", "--optim_type",
        "SGD", "--device_resident", plane, *NARROW_FLAGS])


@pytest.mark.parametrize("plane", ["auto", "never"],
                         ids=["resident", "host_fed"])
def test_train_on_v1_npz_takes_the_steps_of_the_tsv(tmp_path, plane):
    rng = np.random.default_rng(61)
    rows = synth_feature_rows(rng, 14, 24)
    tr = write_feature_file(str(tmp_path / "t.tsv"), rows[:280])
    va = write_feature_file(str(tmp_path / "v.tsv"), rows[280:])
    dirs = {}
    for name, path in (("t", tr), ("v", va)):
        with open(path, "rb") as fh:
            data = fh.read()
        cut = data.index(b"\n", len(data) // 3) + 1
        d = tmp_path / f"{name}_npz"
        d.mkdir()
        for i, part in enumerate((data[:cut], data[cut:])):
            pfm.save_feature_npz(str(d / f"{i:06d}.npz"),
                                 pfp.parse_feature_bytes(part))
        dirs[name] = str(d)
    want = port_train.train(_train_args(tmp_path, tr, va, "m_tsv", plane))
    got = port_train.train(_train_args(tmp_path, dirs["t"], dirs["v"],
                                       "m_npz", plane))
    assert got["resident"] == (plane == "auto")
    assert got["steps"] == want["steps"] == 10
    assert got["step_losses"] == want["step_losses"]
    assert got["valid_accuracies"] == want["valid_accuracies"]
    for g, w in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want["params"]), strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", ["npz_wire", "npz_packed"])
def test_train_refuses_wire_containers(npz_dirs, tmp_path, fmt):
    with pytest.raises(ValueError, match="inference container; training "
                       "and tools need the v1 container"):
        port_train.train(_train_args(tmp_path, npz_dirs[fmt], npz_dirs[fmt],
                                     "m", "auto"))


# --- serve ------------------------------------------------------------

def test_serve_picks_up_npz_drops(npz_dirs, ckpt, tmp_path):
    """One v1 and one v3 batch dropped into a watched directory are
    served once each, with the call_mods CLI's bytes and .done
    markers."""
    watch, out = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    for fmt in ("npz", "npz_packed"):
        shutil.copy(os.path.join(npz_dirs[fmt], "000002.npz"),
                    watch / f"{fmt}.npz")
    cli.main(["serve", "-i", str(watch), "-o", str(out), "-m", ckpt,
              "--once", "--poll_s", "0.01", "--device", "cpu",
              "--compute_dtype", "float32", "--device_batch", "256",
              *NARROW_FLAGS])
    for fmt in ("npz", "npz_packed"):
        _port_calls(ckpt, str(watch / f"{fmt}.npz"), tmp_path / "cli.tsv")
        assert (out / f"{fmt}.npz.call_mods.tsv").read_bytes() == \
            (tmp_path / "cli.tsv").read_bytes()
        assert (out / f"{fmt}.npz.done").exists()
