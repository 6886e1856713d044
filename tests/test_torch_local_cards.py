"""call_mods and serve over several devices of one process (the port's
parallel/mesh.py and ``CallModsEngine`` over a list of devices; the JAX
package's engine over ``make_mesh`` of its local devices), on the CPU.

- ``local_batch_target`` equals JAX's on a mesh of N of the 8 virtual
  CPU devices, and ``shares`` gives each device the real rows that
  ``P("dp")`` gives it in JAX (a full batch, a tail, fewer rows than
  devices), at N = 1-4.
- ``resolve_devices`` (torch.cuda monkeypatched): every visible card
  outside a launch, the rank's card under one, the card named, the CPU;
  no card raises.
- The engine over ``[cpu] * N`` (N = 2, 3) writes the one-device
  engine's bytes on a read-structured TSV at the float16, float32 and
  int8 wires, on ``.npz`` v1 and v3, under ``--device_resident always``,
  on the fused fast5 path and in a ``serve --once`` request; against
  JAX's ``CallModsEngine`` on a mesh of N devices, columns 1-6 and 10
  are identical and both probabilities within 2e-6
  (tests/test_torch_call_mods.py's gate). JAX runs with
  ``packed_wire="force"`` so that it quantizes every int8 batch on the
  read-packed route, as the port does.
- int8: the TSV's reads grow in amplitude read by read, so each share of
  a batch has other per-field maxima than the batch: scales made per
  share would change the bytes.
- Tails: a batch shorter than N runs forwards only on the devices with
  rows, and ``forward_tiles`` counts just those.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from deepsignal_plant_tpu.config import CallConfig as JaxCallConfig
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.parallel import mesh as jax_mesh
from deepsignal_plant_tpu.pipeline.call_mods import \
    CallModsEngine as JaxEngine
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.config import CallConfig, ModelConfig
from deepsignal_plant_tpu_torch.parallel import mesh
from deepsignal_plant_tpu_torch.pipeline import call_mods as port_call_mods
from deepsignal_plant_tpu_torch.pipeline.serve import serve
from deepsignal_plant_tpu_torch.utils import device as port_device
from deepsignal_plant_tpu_torch.utils.fastparse import (
    pack_raw_block, parse_feature_bytes, parse_raw_feature_block)
from deepsignal_plant_tpu_torch.utils.formats import (save_feature_npz,
                                                      save_packed_npz)
from make_synthetic import synth_fast5_dir, synth_genome
from test_torch_call_mods import (NARROW, NARROW_FLAGS,  # noqa: F401
                                  assert_rows_agree, ckpt, read_rows)
from test_torch_fastparse import read_structured_rows

CPU = torch.device("cpu")
#: a multiple of 2 and 3, so the one-device engine cuts the same batches
DEVICE_BATCH = 120
F32 = ["--compute_dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tiny forwards: with the
    suite's workers sharing the cores, each of their OpenMP regions
    waits for threads that are not scheduled (8 of these cases took
    100 s beside five busy processes, 11 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read_bytes(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


# ---- the helpers -----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("requested", [1, 5, 120, 4097, 32768])
def test_local_batch_target_matches_jax(n, requested):
    m = jax_mesh.make_mesh(jax.devices()[:n])
    assert mesh.local_batch_target(requested, n) == \
        jax_mesh.local_batch_target(requested, m)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("rows", ["full", "tail", "fewer_than_devices"])
def test_shares_are_the_rows_p_dp_gives_each_device(n, rows):
    """JAX pads a batch to the target and shards it P("dp"): the real
    rows on each device are the port's share of that device."""
    target = mesh.local_batch_target(10, n)
    n_rows = {"full": target, "tail": target // 2 + 1,
              "fewer_than_devices": n - 1}[rows]
    padded = np.full(target, -1, np.int32)
    padded[:n_rows] = np.arange(n_rows)
    m = jax_mesh.make_mesh(jax.devices()[:n])
    arr = jax.device_put(padded, NamedSharding(m, P("dp")))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    got = mesh.shares(n_rows, target, n)
    assert len(got) == n
    for d, (lo, hi) in zip(m.devices.flat, got):
        real = by_device[d][by_device[d] >= 0]
        assert real.tolist() == list(range(lo, hi))
    assert sum(hi - lo for lo, hi in got) == n_rows


def test_shares_refuse_a_batch_they_cannot_hold():
    with pytest.raises(ValueError):
        mesh.shares(121, 120, 3)
    with pytest.raises(ValueError):
        mesh.shares(10, 121, 3)


def test_resolve_devices(monkeypatch):
    """The table of utils/device.resolve_devices; never a fallback to
    fewer cards or to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for choice in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_device.resolve_devices(choice)
    assert port_device.resolve_devices("cpu") == [CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    every = [torch.device("cuda", i) for i in range(3)]
    assert port_device.resolve_devices(None) == every
    assert port_device.resolve_devices("cuda") == every
    assert port_device.resolve_devices("cuda:2") == [torch.device("cuda", 2)]
    assert port_device.resolve_devices("cpu") == [CPU]
    assert picked == [0, 0, 2]
    with pytest.raises(RuntimeError, match="does not exist"):
        port_device.resolve_devices("cuda:3")
    with pytest.raises(ValueError):
        port_device.resolve_devices("gpu")
    # under a launch: one card a rank
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    for choice in (None, "cuda", "cuda:1"):
        assert port_device.resolve_devices(choice) == [
            torch.device("cuda", 1)]
    assert port_device.resolve_devices("cuda:0") == [torch.device("cuda", 0)]
    assert port_device.resolve_devices("cpu") == [CPU]


# ---- the engine over N devices ---------------------------------------------

def _amplify(rows: list[str]) -> list[str]:
    """Means, stds and signals of the k-th read times (k + 1): each
    share of a batch meets larger values than the share before it.
    Windows of one read stay byte-identical where they overlap."""
    reads: dict[str, int] = {}
    out = []
    for row in rows:
        cols = row.split("\t")
        k = reads.setdefault(cols[4], len(reads)) + 1

        def scale(field, sep=","):
            return sep.join(str(round(float(v) * k, 6))
                            for v in field.split(sep))
        cols[7], cols[8] = scale(cols[7]), scale(cols[8])
        cols[10] = ";".join(scale(r) for r in cols[10].split(";"))
        out.append("\t".join(cols))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A read-structured TSV (10 reads, 374 rows: batches of 120 and a
    14-row tail) and its v1 and v3 .npz directories of two files each."""
    tmp = tmp_path_factory.mktemp("cards")
    rows = _amplify(read_structured_rows(str(tmp), n_reads=10))
    data = ("\n".join(rows) + "\n").encode()
    tsv = tmp / "features.tsv"
    tsv.write_bytes(data)
    out = {"tsv": str(tsv), "rows": len(rows)}
    cut = data.index(b"\n", len(data) // 2) + 1
    for plane in ("v1", "v3"):
        d = tmp / plane
        d.mkdir()
        for i, part in enumerate((data[:cut], data[cut:])):
            path = str(d / f"{i:06d}.npz")
            if plane == "v3":
                save_packed_npz(path, pack_raw_block(
                    parse_raw_feature_block(part)))
            else:
                save_feature_npz(path, parse_feature_bytes(part))
        out[plane] = str(d)
    return out


def port_engine(ckpt, n, device_batch=DEVICE_BATCH, **call):
    cfg = ModelConfig(compute_dtype="float32", dropout_rate=0.0, **NARROW)
    return port_call_mods.CallModsEngine(
        ckpt, cfg, CallConfig(device_batch=device_batch, **call), [CPU] * n)


#: plane -> (input, CallConfig fields)
PLANES = {
    "tsv_float16": ("tsv", {}),
    "tsv_float32": ("tsv", {"transfer_dtype": "float32"}),
    "tsv_int8": ("tsv", {"transfer_dtype": "int8"}),
    "v1": ("v1", {}),
    "v3": ("v3", {}),
    "v3_int8": ("v3", {"transfer_dtype": "int8"}),
    "resident_tsv": ("tsv", {"device_resident": "always"}),
    "resident_v3_int8": ("v3", {"device_resident": "always",
                                "transfer_dtype": "int8"}),
}


@pytest.fixture(scope="module")
def one_device(ckpt, inputs, tmp_path_factory):
    """Each plane's bytes and stats on the one-device engine."""
    tmp = tmp_path_factory.mktemp("one")
    done = {}

    def get(plane):
        if plane not in done:
            inp, call = PLANES[plane]
            out = tmp / f"{plane}.tsv"
            st = port_engine(ckpt, 1, **call).run_features_file(
                inputs[inp], str(out))
            done[plane] = (read_bytes(out), st, str(out))
        return done[plane]
    return get


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_n_devices_write_one_devices_bytes(ckpt, inputs, one_device,
                                           tmp_path, plane, n):
    inp, call = PLANES[plane]
    want, st1, _ = one_device(plane)
    out = tmp_path / "n.tsv"
    st = port_engine(ckpt, n, **call).run_features_file(inputs[inp],
                                                        str(out))
    assert read_bytes(out) == want
    assert st.sites == st1.sites == inputs["rows"]
    assert st.batches == st1.batches
    assert st.devices == ["cpu"] * n and st.device_batch == DEVICE_BATCH
    # a cut of the read-packed route ships at most seq_len - 1 bases more;
    # rows packed from a TSV leave no base outside a window, so a cut
    # drops none (extract's v3 files hold whole reads: there a cut also
    # drops the bases between two sites' windows)
    cuts = (n - 1) * st.batches
    assert st1.bases_uploaded <= st.bases_uploaded <= \
        st1.bases_uploaded + 12 * cuts
    if st.persite_sites:
        assert st.bases_uploaded == st1.bases_uploaded
    if call.get("device_resident"):
        assert st.resident_segments == st1.resident_segments
        assert st.resident_k_chunks == st1.resident_k_chunks


#: planes held against JAX's engine on a mesh of N devices
JAX_PLANES = ("tsv_float16", "tsv_float32", "tsv_int8", "v1", "v3")


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("plane", JAX_PLANES)
def test_n_devices_match_jax_on_n_devices(ckpt, inputs, one_device,
                                          tmp_path, plane, n):
    inp, call = PLANES[plane]
    got = tmp_path / "port.tsv"
    port_engine(ckpt, n, **call).run_features_file(inputs[inp], str(got))
    assert read_bytes(got) == one_device(plane)[0]
    jcfg = JaxModelConfig(recurrence="scan", compute_dtype="float32",
                          dropout_rate=0.0, **NARROW)
    eng = JaxEngine(ckpt, jcfg, JaxCallConfig(
        transfer_dtype=call.get("transfer_dtype", "float16"),
        device_batch=DEVICE_BATCH, packed_wire="force"),
        mesh=jax_mesh.make_mesh(jax.devices()[:n]))
    want = tmp_path / "jax.tsv"
    eng.run_features_file(inputs[inp], str(want))
    assert_rows_agree(read_rows(str(got)), read_rows(str(want)))


def test_int8_scales_are_the_batchs(ckpt, inputs):
    """Each share carries its batch's scales; the fixture would fail the
    byte test under scales made per share: quantizing a share of a batch
    on its own gives other scales on most shares."""
    eng = port_engine(ckpt, 3)      # float16: the batch before int8
    batches = eng._packed_plane_batches(
        inputs["tsv"], port_call_mods.CallStats(device_batch=DEVICE_BATCH))
    try:
        batch = next(batches)
    finally:
        batches.close()
    assert batch.n == DEVICE_BATCH
    q = dataclasses.replace(
        batch, arrays=port_call_mods.quantize_packed(batch.arrays))
    differ = 0
    for lo, hi in mesh.shares(batch.n, DEVICE_BATCH, 3):
        share = port_call_mods._share(q, 0, lo, hi, 13)
        np.testing.assert_array_equal(share.arrays[-1], q.arrays[-1])
        own = port_call_mods.quantize_packed(
            port_call_mods._share(batch, 0, lo, hi, 13).arrays)[-1]
        differ += not np.array_equal(own, q.arrays[-1])
    assert differ >= 2


@pytest.mark.parametrize("wire", ["float16", "float32"])
@pytest.mark.parametrize("n_rows,device_batch,calls", [
    (7, 6, [[2, 1], [2], [2]]),       # a full batch and a 1-row tail
    (2, 3, [[1], [1], []]),           # fewer rows than devices
])
def test_short_batches_run_only_devices_with_rows(ckpt, inputs, tmp_path,
                                                  wire, n_rows,
                                                  device_batch, calls):
    """Rows a forward on each of 3 replicas; forward_tiles counts the
    forwards that ran, and the bytes are the one-device engine's."""
    with open(inputs["tsv"], "rb") as fh:
        head = b"".join(fh.readline() for _ in range(n_rows))
    small = tmp_path / "small.tsv"
    small.write_bytes(head)
    eng = port_engine(ckpt, 3, device_batch, transfer_dtype=wire)
    seen = [[] for _ in eng.models]
    for i, m in enumerate(eng.models):
        m.register_forward_hook(
            lambda mod, args, out, i=i: seen[i].append(len(args[0].kmer)))
    st = eng.run_features_file(str(small), str(tmp_path / "n.tsv"))
    assert seen == calls
    assert st.forward_tiles == sum(map(len, calls))
    port_engine(ckpt, 1, device_batch, transfer_dtype=wire) \
        .run_features_file(str(small), str(tmp_path / "one.tsv"))
    assert read_bytes(tmp_path / "n.tsv") == read_bytes(tmp_path / "one.tsv")


def test_replicas_are_separate_modules(ckpt):
    eng = port_engine(ckpt, 3)
    assert len({id(m) for m in eng.models}) == 3
    assert eng.model is eng.models[0] and eng.device == CPU
    assert eng.device_batch == DEVICE_BATCH
    assert port_engine(ckpt, 3, device_batch=100).device_batch == 102


# ---- the CLI paths: fused fast5 and serve ----------------------------------

@pytest.fixture(scope="module")
def fast5_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("f5cards")
    rng = np.random.default_rng(57)
    genome = synth_genome(rng, {"chr1": 4000})
    synth_fast5_dir(str(tmp / "f5"), genome, rng, n_reads=6, read_len=400,
                    max_event_len=25, meth_mode="mixed")
    return str(tmp / "f5")


def _on_n_cpus(monkeypatch, n):
    """The CLI's device list: ``n`` CPU devices, as ``cuda`` would give
    n cards."""
    monkeypatch.setattr(port_device, "resolve_devices",
                        lambda choice=None: [CPU] * n)
    monkeypatch.setattr(port_call_mods, "resolve_devices",
                        lambda choice=None: [CPU] * n)


@pytest.mark.parametrize("n", [2, 3])
def test_fused_fast5_over_n_devices(ckpt, fast5_run, tmp_path, monkeypatch,
                                    capsys, n):
    outs = {}
    for k in (1, n):
        _on_n_cpus(monkeypatch, k)
        out = tmp_path / f"calls{k}.tsv"
        cli.main(["call_mods", "-i", fast5_run, "-m", ckpt, "-o", str(out),
                  "--device", "cpu", "--f5_batch_size", "2", "--device_batch",
                  "60", *NARROW_FLAGS, *F32, "--verbose_stages"])
        outs[k] = read_bytes(out)
    assert outs[1] == outs[n] and outs[1].count(b"\n") > 60
    assert f'"devices": {["cpu"] * n}'.replace("'", '"') in \
        capsys.readouterr().out


@pytest.mark.parametrize("n", [2, 3])
def test_serve_request_over_n_devices(ckpt, inputs, tmp_path, monkeypatch,
                                      n):
    watch = tmp_path / "watch"
    watch.mkdir()
    with open(inputs["tsv"], "rb") as fh:
        (watch / "drop.tsv").write_bytes(fh.read())
    got = {}
    for k in (1, n):
        _on_n_cpus(monkeypatch, k)
        res = tmp_path / f"served{k}"
        served = serve(cli.build_parser().parse_args([
            "serve", "--watch_dir", str(watch), "--result_dir", str(res),
            "-m", ckpt, "--once", "--poll_s", "0.05", "--device", "cpu",
            "--device_batch", str(DEVICE_BATCH), *NARROW_FLAGS, *F32]))
        assert [name for name, _ in served] == ["drop.tsv"]
        assert served[0][1].devices == ["cpu"] * k
        got[k] = read_bytes(res / "drop.tsv.call_mods.tsv")
    assert got[1] == got[n] and got[1].count(b"\n") == inputs["rows"]
