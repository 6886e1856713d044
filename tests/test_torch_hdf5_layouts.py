"""The parts of HDF5 that h5py writes at ``libver="latest"``, read by
the port's reader (deepsignal_plant_tpu_torch/io/hdf5.py) and held
against h5py: dense link and attribute storage (fractal heaps and v2
B-trees, with and without creation order), the extensible-array, v2
B-tree and paged fixed-array chunk indexes, filtered or not, with
partial last chunks; a tombo run in those layouts gives the JAX
package's ``extract`` bytes; mutated files of each layout, and of a VBZ
fast5, return or raise HDF5FormatError within a time limit."""
from __future__ import annotations

import multiprocessing as mp
import os
import queue

import h5py
import numpy as np
import pytest

from deepsignal_plant_tpu import cli as jax_cli
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.io import hdf5
from make_synthetic import synth_fast5_dir, synth_genome

FILTERS = {"none": {},
           "gzip_shuffle_fletcher": dict(compression="gzip", shuffle=True,
                                         fletcher32=True)}


def _layouts(rng) -> dict:
    """name -> (data, create_dataset keywords); each name's index is the
    one h5py picks at libver="latest"."""
    a1 = rng.integers(-30000, 30000, 1003).astype("<i2")
    a2 = rng.normal(size=(37, 23)).astype(">f4")
    return {
        # one unlimited dimension: extensible array (index 4); 2-D with
        # the unlimited dimension first, last, and a bounded maximum
        "earray": (a1, dict(maxshape=(None,), chunks=(10,))),
        "earray_paged": (rng.integers(0, 9, 6001).astype(np.int8),
                         dict(maxshape=(None,), chunks=(3,))),
        "earray_2d": (a2, dict(maxshape=(None, 23), chunks=(5, 4))),
        "earray_2d_last": (a2, dict(maxshape=(37, None), chunks=(5, 4))),
        "earray_2d_max": (a2, dict(maxshape=(None, 50), chunks=(5, 4))),
        # several unlimited dimensions: v2 B-tree (index 5)
        "btree2": (a2, dict(maxshape=(None, None), chunks=(5, 4))),
        "btree2_deep": (np.tile(a2, (3, 4)), dict(maxshape=(None, None),
                                                  chunks=(3, 2))),
        # more than 1,024 chunks of a fixed shape: paged fixed array
        "farray_paged": (rng.integers(0, 100, 3001).astype(np.int8),
                         dict(chunks=(2,))),
        "farray_paged_2d": (rng.integers(0, 99, (101, 77)).astype("<u2"),
                            dict(chunks=(2, 3))),
        "farray_max": (a2, dict(maxshape=(50, 40), chunks=(5, 4))),
    }


@pytest.mark.parametrize("filt", sorted(FILTERS))
def test_chunk_indexes_match_h5py(tmp_path, filt):
    rng = np.random.default_rng(len(filt))
    path = str(tmp_path / "layouts.h5")
    layouts = _layouts(rng)
    with h5py.File(path, "w", libver="latest") as f:
        for name, (data, kw) in layouts.items():
            f.create_dataset(name, data=data, **kw, **FILTERS[filt])
        # chunks never written, and a dataset grown after writing
        d = f.create_dataset("sparse_paged", shape=(5000,), dtype="<i4",
                             chunks=(2,), **FILTERS[filt])
        d[10:12], d[4000:4003] = 7, 9
        d = f.create_dataset("sparse_earray", shape=(60001,), dtype="<i4",
                             maxshape=(None,), chunks=(3,), **FILTERS[filt])
        d[100:103], d[59000:59010] = 5, 3
        d = f.create_dataset("grown", shape=(10,), maxshape=(None,),
                             dtype="<i4", chunks=(4,), **FILTERS[filt])
        d[:] = np.arange(10)
        d.resize((1001,))
        d[990:] = 1
    with h5py.File(path) as ref, hdf5.File(path) as f:
        assert f.keys() == sorted(ref.keys())
        for name in ref:
            got, want = f[name][()], ref[name][()]
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            if name in layouts:
                np.testing.assert_array_equal(got, layouts[name][0])


def _attr_equal(got, want) -> bool:
    if isinstance(want, str):
        return got == want.encode()
    return np.asarray(got).dtype == np.asarray(want).dtype and \
        np.array_equal(got, want)


@pytest.mark.parametrize("track_order", [False, True])
@pytest.mark.parametrize("n", [9, 40, 1500])
def test_dense_links_and_attributes_match_h5py(tmp_path, track_order, n):
    """Past 8 links or attributes a group keeps them in a fractal heap
    under v2 B-trees of name hashes and, with track_order, of creation
    order; h5py lists them in creation order when tracked, else by name.
    A 160 kB attribute is a huge heap object; 1,500 links make the name
    index two levels deep and the heap's root an indirect block."""
    rng = np.random.default_rng(n)
    path = str(tmp_path / "dense.h5")
    with h5py.File(path, "w", libver="latest", track_order=track_order) as f:
        g = f.create_group("links", track_order=track_order)
        for i in rng.permutation(n):
            if i % 3:
                g.create_group(f"group_{i}")
            else:
                g.create_dataset(f"data_{i}", data=np.arange(i % 7))
        a = f.create_group("attrs", track_order=track_order)
        for i in rng.permutation(min(n, 200)):
            a.attrs[f"a{i}"] = [np.int32(i), np.float64(i / 3),
                                np.bytes_(f"v{i}"), f"str {i}",
                                np.arange(i % 5, dtype="<i8")][i % 5]
        a.attrs["huge"] = np.arange(20_000, dtype=np.float64)
    with h5py.File(path) as ref, hdf5.File(path) as f:
        assert f["links"].keys() == list(ref["links"].keys())
        assert f.keys() == list(ref.keys())
        for name in list(ref["links"])[:50]:
            if name.startswith("data_"):
                np.testing.assert_array_equal(f["links"][name][()],
                                              ref["links"][name][()])
        got, want = f["attrs"].attrs, dict(ref["attrs"].attrs.items())
        assert list(got) == list(want)
        bad = [k for k in want if not _attr_equal(got[k], want[k])]
        assert not bad


# -- a tombo run at libver="latest" ----------------------------------------

def latest_twin(src: str, dst: str) -> None:
    """``src`` rewritten by h5py at libver="latest": every group with
    more than 8 links and attributes (dense storage), Signal chunked with
    maxshape=(None,) (an extensible-array index), gzip and shuffle."""
    with h5py.File(src) as s, h5py.File(dst, "w", libver="latest") as d:
        def copy(sg, dg):
            for k, v in sg.attrs.items():
                dg.attrs[k] = v
            for i in range(9):
                dg.attrs[f"extra_attr_{i}"] = np.int64(i)
            for k, v in sg.items():
                if isinstance(v, h5py.Group):
                    copy(v, dg.create_group(k))
                    continue
                kw = dict(maxshape=(None,), chunks=(500,),
                          compression="gzip", shuffle=True) \
                    if k == "Signal" else {}
                ds = dg.create_dataset(k, data=v[()], **kw)
                for ak, av in v.attrs.items():
                    ds.attrs[ak] = av
            for i in range(9):
                dg.create_group(f"extra_group_{i}")
        copy(s, d)


@pytest.fixture(scope="module")
def latest_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("latest")
    rng = np.random.default_rng(17)
    genome = synth_genome(rng, {"chr1": 4000, "chr2": 3000})
    src, dst = str(tmp / "orig"), str(tmp / "latest")
    synth_fast5_dir(src, genome, rng, n_reads=6, read_len=400,
                    max_event_len=25, meth_mode="mixed")
    os.makedirs(dst)
    for fn in sorted(os.listdir(src)):
        latest_twin(os.path.join(src, fn), os.path.join(dst, fn))
    return {"orig": src, "latest": dst}


def test_latest_tombo_run_extract_matches_jax(latest_run, tmp_path):
    path = os.path.join(latest_run["latest"],
                        sorted(os.listdir(latest_run["latest"]))[0])
    with h5py.File(path) as f:
        assert f["Raw/Reads/Read_0/Signal"].maxshape == (None,)
        assert len(f["Raw/Reads/Read_0"].attrs) > 8
    outs = {}
    for name, main, run in (("port", cli.main, "latest"),
                            ("jax", jax_cli.main, "latest"),
                            ("orig", cli.main, "orig")):
        out = str(tmp_path / f"{name}.tsv")
        main(["extract", "-i", latest_run[run], "-o", out, "--nproc", "1",
              "--f5_batch_size", "4"])
        with open(out, "rb") as fh:
            outs[name] = fh.read()
    assert outs["port"].count(b"\n") > 150
    assert outs["port"] == outs["jax"] == outs["orig"]


# -- mutated files of the new layouts ---------------------------------------

def walk_file(path: str) -> int:
    """Read every group's links and attributes and every dataset of a
    file with the port's reader; the number of objects read."""
    seen: set[int] = set()
    with hdf5.File(path) as f:
        stack = [f.root]
        while stack:
            obj = stack.pop()
            if obj.addr in seen:
                continue
            seen.add(obj.addr)
            dict(obj.attrs)
            if isinstance(obj, hdf5.Dataset):
                obj.read()
            else:
                stack += [obj[k] for k in obj.keys()]
    return len(seen)


def _walk_mutants(paths, q):
    """Child process: walk each file, report (path, outcome) as it ends;
    None after the last."""
    for p in paths:
        try:
            walk_file(p)
            q.put((p, "read"))
        except hdf5.HDF5FormatError:
            q.put((p, "HDF5FormatError"))
        except Exception as exc:  # noqa: BLE001 - reported as a failure
            q.put((p, f"{type(exc).__name__}: {exc}"))
    q.put(None)


def _mutant_source(kind: str, path: str) -> None:
    rng = np.random.default_rng(3)
    sig = rng.integers(-2000, 2000, 3000).astype("<i2")
    if kind == "vbz":
        import torch_vbz as tv
        hdf5.write_file(path, {"Raw": {"Reads": {"Read_0": {
            "@attrs": {"read_id": np.bytes_("m")},
            "Signal": (hdf5.Chunked(sig, (700,), [(32020, tv.MINKNOW)],
                                    tv.chunk_encoder()), {})}}}})
        return
    with h5py.File(path, "w", libver="latest",
                   track_order=kind == "dense_ordered") as f:
        if kind.startswith("dense"):
            g = f.create_group("g")
            for i in range(12):
                g.create_group(f"child_{i}")
                g.attrs[f"attr_{i}"] = np.int64(i)
            g.attrs["s"] = "a variable-length string"
        elif kind == "earray":
            f.create_dataset("x", data=sig, maxshape=(None,), chunks=(50,),
                             compression="gzip", shuffle=True,
                             fletcher32=True)
            f.create_dataset("y", data=sig[:300], maxshape=(None,),
                             chunks=(2,))
        elif kind == "btree2":
            f.create_dataset("x", data=sig.reshape(60, 50),
                             maxshape=(None, None), chunks=(7, 9),
                             compression="gzip")
        elif kind == "farray_paged":
            f.create_dataset("x", data=sig, chunks=(2,), fletcher32=True)


@pytest.mark.parametrize("kind", ["dense", "dense_ordered", "earray",
                                  "btree2", "farray_paged", "vbz"])
def test_mutated_fast5_never_hangs_or_crashes(tmp_path, kind):
    """Byte mutations and truncations of a file of each new layout, and
    of a VBZ fast5, each read whole or raise HDF5FormatError within a
    time limit (one spawned child walks them in turn and reports each as
    it ends, so a hang or a crash shows as a missing report). A twin of
    the test of the same name in test_torch_hdf5.py."""
    src = str(tmp_path / "ok.h5")
    _mutant_source(kind, src)
    assert walk_file(src) > 1
    data = bytes(open(src, "rb").read())
    rng = np.random.default_rng(len(kind))
    paths = []
    for i in range(60):
        m = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
        if i % 10 == 9:
            m = m[:int(rng.integers(8, len(m)))]
        p = str(tmp_path / f"m{i}.h5")
        open(p, "wb").write(m)
        paths.append(p)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_walk_mutants, args=(paths, q))
    proc.start()
    outcomes = {}
    try:
        for i, p in enumerate(paths):
            try:
                got = q.get(timeout=60 if i == 0 else 10)
            except queue.Empty:
                pytest.fail(f"{os.path.basename(p)} hung or crashed the "
                            f"reader (exit code {proc.exitcode})")
            assert got[0] == p
            outcomes[os.path.basename(p)] = got[1]
        assert q.get(timeout=10) is None
        proc.join(10)
        assert not proc.is_alive() and proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
    bad = {p: o for p, o in outcomes.items()
           if o not in ("read", "HDF5FormatError")}
    assert not bad
    assert "HDF5FormatError" in outcomes.values()
