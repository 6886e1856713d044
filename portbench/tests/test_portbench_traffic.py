"""The generators, the v3 writer and the FLOP arithmetic, on the CPU:
the same seed gives the same input, the program's readers read the
benchmark's files back to the generated values, and the FLOP count
reproduces K1's bound."""
import os

import numpy as np
import pytest

from portbench.lib import flops, peaks, spec

SITES = 1500


def _traffic(name, **kw):
    return {**spec.read_json(spec.BENCH_DIR, "traffic", name + ".json"),
            "sites": SITES, **kw}


def _make(tmp_path, name, seed, sub, **kw):
    p = _traffic(name, **kw)
    d = tmp_path / sub
    d.mkdir()
    return spec.load_module("traffic", p["kind"]).make(p, seed, str(d),
                                                       p["sites"])


def _bytes(path):
    if os.path.isdir(path):
        return b"".join(open(os.path.join(path, f), "rb").read()
                        for f in sorted(os.listdir(path)))
    return open(path, "rb").read()


@pytest.mark.parametrize("name,kw", [("allc_tsv_262k", {}),
                                     ("allc_npz_1m", {"reads_per_file": 1})])
def test_same_seed_same_input(tmp_path, name, kw):
    seed = 2**31 + 2**30 + 17        # past 32 signed bits
    a = _make(tmp_path, name, seed, "a", **kw)
    b = _make(tmp_path, name, seed, "b", **kw)
    c = _make(tmp_path, name, seed + 1, "c", **kw)
    assert a.sites == b.sites == c.sites == SITES
    assert _bytes(a.path) == _bytes(b.path)
    assert _bytes(a.path) != _bytes(c.path)
    assert a.sample.info == b.sample.info
    np.testing.assert_array_equal(a.sample.signals, b.sample.signals)


def test_sites_are_every_c_of_the_reads(tmp_path):
    inp = _make(tmp_path, "allc_tsv_262k", 5, "t")
    s = inp.sample
    assert len(s.index) == SITES                 # every site sampled
    assert (s.kmer[:, 6] == 1).all()             # the centre is a C
    assert all(k[2:3] == b"C" for k in s.kmer5)
    # dense plant C sites: about one a 5.6 bases at 36% GC
    ends = [int(line.split(b"\t")[1]) for line in s.info[:50]]
    assert len(set(ends)) == 50


def test_tsv_reads_back_through_the_program(tmp_path):
    from deepsignal_plant_tpu_torch.io.batching import (
        batches_from_features_file)
    inp = _make(tmp_path, "allc_tsv_262k", 11, "t")
    fbs = list(batches_from_features_file(inp.path, 4096, 13, 16, 2,
                                          out_dtype="float32"))
    kmer = np.concatenate([fb.kmer for fb in fbs])
    s = inp.sample
    np.testing.assert_array_equal(kmer, s.kmer)
    for name, want in (("base_means", s.means), ("base_stds", s.stds),
                       ("base_signal_lens", s.lens),
                       ("signals", s.signals)):
        got = np.concatenate([getattr(fb, name) for fb in fbs])
        np.testing.assert_array_equal(got, want, err_msg=name)
    info = [i.encode() for fb in fbs for i in fb.sampleinfo]
    assert info == s.info


def test_v3_reads_back_through_the_program(tmp_path):
    from deepsignal_plant_tpu_torch.utils.formats import (
        feature_npz_paths, load_packed_npz, wire_npz_version)
    inp = _make(tmp_path, "allc_npz_1m", 12, "n", reads_per_file=1,
                sites=6000)
    files = feature_npz_paths(inp.path)
    assert len(files) > 1
    assert {wire_npz_version(f) for f in files} == {3}
    blocks = [load_packed_npz(f) for f in files]
    s = inp.sample
    win = [pb.window_index() for pb in blocks]
    np.testing.assert_array_equal(
        np.concatenate([pb.codes[w] for pb, w in zip(blocks, win)]),
        s.kmer)
    for name, want in (("means", s.means), ("stds", s.stds),
                       ("lens", s.lens), ("rect", s.signals)):
        got = np.concatenate([getattr(pb, name)[w].astype(np.float32)
                              for pb, w in zip(blocks, win)])
        np.testing.assert_array_equal(got, want, err_msg=name)
    info = [pb.raw[a:b] for pb in blocks
            for a, b in zip(pb.row_starts.tolist(), pb.info_ends.tolist())]
    assert info == s.info


def test_flops_reproduce_k1_bound():
    cfg = spec.read_json(spec.BENCH_DIR, "configs",
                         "dp2_bilstm_b13s16_bf16.json")
    per_site = sum(flops.layer_flops_per_site(layer, 13)
                   for layer in flops.lstm_layers(cfg))
    assert per_site == pytest.approx(116.5e6, rel=1e-3)
    bound = flops.lstm_bound_seconds(cfg, 4096, 1, peaks.ITEMSIZE[
        "bfloat16"], peaks.PEAK_FLOPS["bfloat16"], peaks.PEAK_BYTES)
    assert bound * 1e3 == pytest.approx(0.482, abs=5e-4)
    # the whole forward adds the fc layers to the LSTMs' products
    assert flops.forward_flops_per_site(cfg) > per_site


def test_layers_are_the_published_shapes():
    cfg = spec.read_json(spec.BENCH_DIR, "configs",
                         "dp2_bilstm_b13s16_f32.json")
    got = [(l.F, l.H, l.seq_out) for l in flops.lstm_layers(cfg)]
    assert got == [(7, 128, True), (16, 128, True), (256, 256, True),
                   (512, 256, True), (512, 256, False)]
