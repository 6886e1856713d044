"""The port's extract (deepsignal_plant_tpu_torch/pipeline/extract.py) on
the CPU: its native extraction functions bitwise against the JAX
package's library on the same inputs, and its CLI's TSV bytes against
JAX extract's across the flag matrix (downsampling even and compat with a
seed, motifs, zscore, region/positions/reference filters, gzip, a
rotating output directory, event lengths above signal_len, one and two
worker processes)."""
import gzip
import os
import random

import numpy as np
import pytest

from deepsignal_plant_tpu import cli as jax_cli
from deepsignal_plant_tpu.pipeline import extract as jax_extract
from deepsignal_plant_tpu.utils import fastparse as jfp
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.pipeline import extract
from deepsignal_plant_tpu_torch.utils import fastparse as pfp
from make_synthetic import synth_fast5_dir, synth_genome, write_fasta


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """12 reads of 500 bases, events of 3-24 samples (above signal_len 16
    for the downsampling), both strands, two contigs, a reference and a
    positions file."""
    tmp = tmp_path_factory.mktemp("extract")
    rng = np.random.default_rng(5)
    genome = synth_genome(rng, {"chr1": 4000, "chr2": 3000})
    ref = write_fasta(str(tmp / "ref.fa"), genome)
    synth_fast5_dir(str(tmp / "f5"), genome, rng, n_reads=12, read_len=500,
                    max_event_len=25, meth_mode="mixed")
    pos = tmp / "positions.tsv"
    lines = [f"chr1\t{p}\t{s}" for p in range(0, 4000, 3) for s in "+-"]
    pos.write_text("\n".join(lines) + "\n")
    return {"dir": str(tmp / "f5"), "ref": ref, "positions": str(pos)}


def _read_out(path):
    if os.path.isdir(path):
        return {f: _read_out(os.path.join(path, f))
                for f in sorted(os.listdir(path))}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def _both(run, tmp_path, extra, nproc=1, jax_nproc=1):
    """The port's and JAX's output (decompressed bytes, or a dict of
    them for a directory) of one flag set."""
    extra = [run[a[1:]] if a.startswith("@") else a for a in extra]
    outs = []
    for name, main, np_ in (("port", cli.main, nproc),
                            ("jax", jax_cli.main, jax_nproc)):
        out = str(tmp_path / f"{name}.tsv")
        main(["extract", "-i", run["dir"], "-o", out, "--nproc", str(np_),
              "--f5_batch_size", "4", *extra])
        gz = "--gzip" in extra and "--w_is_dir" not in extra
        outs.append(_read_out(out + ".gz" if gz else out))
    return outs


CASES = {
    "even": [],
    "compat_seed": ["--downsample", "compat", "--seed", "7"],
    "chg": ["--motifs", "CHG"],
    "chh": ["--motifs", "CHH", "--mod_loc", "0"],
    "zscore": ["--normalize_method", "zscore"],
    "zscore_compat": ["--normalize_method", "zscore", "--downsample",
                      "compat", "--seed", "3"],
    "region": ["--region", "chr1:800-3000"],
    "positions": ["--positions", "@positions"],
    "reference": ["--reference_path", "@ref"],
    "gzip": ["--gzip"],
    "w_is_dir": ["--w_is_dir", "yes", "--w_batch_num", "1"],
    "label0_kmer11": ["--methy_label", "0", "--seq_len", "11"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_tsv_matches_jax(run, tmp_path, case):
    got, want = _both(run, tmp_path, CASES[case])
    assert got == want
    assert (sum(len(v) for v in got.values()) if isinstance(got, dict)
            else len(got)) > 1000


@pytest.mark.parametrize("case", ["compat_seed", "w_is_dir_gzip"])
def test_extract_pooled_bytes_match_jax(run, tmp_path, case):
    """Two worker processes write what one JAX process writes."""
    extra = CASES.get(case) or ["--w_is_dir", "yes", "--w_batch_num", "2",
                                "--gzip"]
    got, want = _both(run, tmp_path, extra, nproc=2)
    assert got == want


def test_extract_refuses_npz_formats(run, tmp_path):
    for fmt in ("npz", "npz_wire", "npz_packed"):
        with pytest.raises(ValueError, match="not yet ported"):
            cli.main(["extract", "-i", run["dir"], "-o",
                      str(tmp_path / fmt), "--w_format", fmt])
        assert not (tmp_path / fmt).exists()


# --- the native functions, bitwise against the JAX library -------------

def _signal_and_events(rng, n_bases=300, max_len=25):
    lens = rng.integers(1, max_len, n_bases).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    sig = rng.normal(480.0, 60.0, int(lens.sum())) * 0.1788 + 1.788
    return sig, starts, lens


@pytest.mark.parametrize("seed", range(4))
def test_extract_norm_stats_bitwise(seed):
    rng = np.random.default_rng(seed)
    sig, starts, lens = _signal_and_events(rng)
    got = pfp.extract_norm_stats(sig, starts, lens, 16)
    want = jfp.extract_norm_stats(sig, starts, lens, 16)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    # the numpy chain gives the same values
    norm = extract.normalize_signals(sig, "mad")
    means, stds = extract.segment_stats(norm, starts, lens)
    assert got["norm"].tobytes() == norm.tobytes()
    assert got["means"].tobytes() == means.tobytes()
    rect = extract.build_signal_rect(norm, starts, lens, 16)
    assert got["rect16"].tobytes() == rect.astype(np.float16).tobytes()
    assert pfp.build_rect_f16(norm, starts, lens, 16).tobytes() == \
        jfp.build_rect_f16(norm, starts, lens, 16).tobytes()


def test_corrupt_event_table_returns_none():
    rng = np.random.default_rng(1)
    sig, starts, lens = _signal_and_events(rng, 50)
    bad = lens.copy()
    bad[-1] += 5                            # runs past the signal
    for fn in (lambda: pfp.extract_norm_stats(sig, starts, bad, 16),
               lambda: pfp.build_rect_f16(sig, starts, bad, 16),
               lambda: pfp.segment_stats_exact_native(sig, starts, bad),
               lambda: pfp.build_rect_compat(sig, starts, bad, 16,
                                             pfp.compat_sampler(1))):
        assert fn() is None
    neg = lens.copy()
    neg[3] = -1
    assert pfp.extract_norm_stats(sig, starts, neg, 16) is None
    assert jfp.extract_norm_stats(sig, starts, neg, 16) is None


@pytest.mark.parametrize("seed", range(3))
def test_compat_chain_bitwise(seed):
    rng = np.random.default_rng(10 + seed)
    sig, starts, lens = _signal_and_events(rng, 200, 60)
    norm = pfp.normalize_mad_native(sig)
    assert norm.tobytes() == jfp.normalize_mad_native(sig).tobytes()
    assert norm.tobytes() == extract.normalize_signals(sig).tobytes()
    m, s = pfp.segment_stats_exact_native(norm, starts, lens)
    jm, js = jfp.segment_stats_exact_native(norm, starts, lens)
    em, es = extract.segment_stats_exact(norm, starts, lens)
    assert m.tobytes() == jm.tobytes() == em.tobytes()
    assert s.tobytes() == js.tobytes() == es.tobytes()
    r = pfp.build_rect_compat(norm, starts, lens, 16,
                              pfp.compat_sampler(seed))
    jr = jfp.build_rect_compat(norm, starts, lens, 16,
                               jfp.compat_sampler(seed))
    # the pure-Python loop on random.Random's stream
    pr = extract.build_signal_rect(norm, starts, lens, 16, "compat",
                                   random.Random(seed))
    assert r.tobytes() == jr.tobytes() == pr.tobytes()


@pytest.mark.parametrize("n,k", [(20, 16), (100, 16), (17, 16), (5000, 16),
                                 (30, 0), (1 << 20, 16)])
def test_compat_sampler_matches_random(n, k):
    ours, ref = pfp.compat_sampler(12345), random.Random(12345)
    for _ in range(3):
        assert ours.sample(range(n), k) == sorted(ref.sample(range(n), k))


def test_format_feature_cols_and_info_rows_bitwise():
    rng = np.random.default_rng(4)
    n, L, S = 40, 13, 16
    means = np.round(rng.normal(0, 1, (n, L)), 8)
    means[0, 0] = -0.0
    means[0, 1] = 3e-5
    means[0, 2] = -4.0e-7
    stds = np.abs(rng.normal(0, 1, (n, L)))
    lens = rng.integers(1, 30, (n, L)).astype(np.int32)
    rect = rng.normal(0, 2, (n, L, S))
    got = pfp.format_feature_cols(means, stds, lens, rect)
    assert got == jfp.format_feature_cols(means, stds, lens, rect)
    from deepsignal_plant_tpu_torch.utils.formats import format_feature_row
    row = format_feature_row("c", 1, "+", 2, "r", "t", "A" * L, means[0],
                             stds[0], lens[0], np.around(rect[0], 6).tolist(),
                             1)
    assert row.split("\t")[7:11] == got[0].split("\t")
    pos = rng.integers(0, 10**9, 30)
    pis = np.where(rng.random(30) < 0.5, -1, pos)
    assert pfp.format_info_rows("chr_1", "-", "read-9", "t", pos, pis)[0] \
        == jfp.format_info_rows("chr_1", "-", "read-9", "t", pos, pis)[0]


def test_features_to_packed_and_batch_match_jax(run):
    """One fast5 batch's blocks: the read-packed wire and the float32
    per-site arrays equal JAX's, array for array."""
    from deepsignal_plant_tpu.io.fast5 import read_tombo_fast5 as jread
    from deepsignal_plant_tpu_torch.io.fast5 import read_tombo_fast5
    paths = sorted(os.listdir(run["dir"]))[:5]
    for f16 in (True, False):
        popts = extract.ExtractOptions(rect_f16=f16)
        jopts = jax_extract.ExtractOptions(rect_f16=f16)
        pctx = extract.ExtractContext.build(popts)
        jctx = jax_extract.ExtractContext.build(jopts)
        pf = [extract.extract_read_features(
            read_tombo_fast5(os.path.join(run["dir"], p)), pctx)
            for p in paths]
        jf = [jax_extract.extract_read_features(
            jread(os.path.join(run["dir"], p)), jctx) for p in paths]
        if f16:
            a, b = extract.features_to_packed(pf), \
                jax_extract.features_to_packed(jf)
            assert a.raw == b.raw
            for k in ("row_starts", "info_ends", "centers", "codes",
                      "means", "stds", "lens", "rect", "labels"):
                x, y = getattr(a, k), getattr(b, k)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
        else:
            a = extract.features_to_batch(pf, 13, 16)
            b = jax_extract.features_to_batch(jf, 13, 16)
            assert a.sampleinfo == b.sampleinfo
            for k in ("kmer", "base_means", "base_stds", "base_signal_lens",
                      "signals", "labels"):
                x, y = getattr(a, k), getattr(b, k)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
