"""The port's call_freq (deepsignal_plant_tpu_torch) against the JAX
package's on the same call_mods rows, on the CPU.

Gates: the native call-row parser gives the JAX parser's arrays (and the
JAX package's plain Python parser's values); sort_segment_reduce on the
CPU gives the JAX function's order, segments and sums; the call_freq CLI
writes the JAX CLI's bytes across the flag matrix, with and without
--device_agg (gzip outputs compared decompressed: the gzip header holds
a time stamp).
"""
import gzip
import os

import numpy as np
import pytest

from deepsignal_plant_tpu.cli import main as jax_main
from deepsignal_plant_tpu.ops.segment_agg import \
    sort_segment_reduce as jax_reduce
from deepsignal_plant_tpu.pipeline import call_freq as jax_cf
from deepsignal_plant_tpu.utils.fastparse import \
    parse_call_bytes as jax_parse
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.ops.segment_agg import sort_segment_reduce
from deepsignal_plant_tpu_torch.pipeline import call_freq as port_cf
from deepsignal_plant_tpu_torch.utils.fastparse import parse_call_bytes
from make_synthetic import write_fasta

CHROMS = ["Chr1", "Chr10", "Chr2", "scaffold_9", "ChrC"]
ARRAYS = ("chrom_ids", "pos", "strand", "pos_in_strand", "p0", "p1",
          "label", "kmer_off", "kmer_len")


def call_rows(rng, n, pos_base=0, n_pos=500, chroms=CHROMS):
    """call_mods rows: several contigs, both strands, repeated sites,
    -1 pos_in_strand, 6-decimal probabilities like the emitter's."""
    c = rng.integers(len(chroms), size=n)
    pos = pos_base + rng.integers(0, n_pos, size=n)
    minus = rng.random(n) < 0.5
    pis = np.where(rng.random(n) < 0.1, -1, pos)
    p1 = np.round(rng.random(n), 6)
    rows = []
    for i in range(n):
        q1 = float(p1[i])
        q0 = round(1.0 - q1, 6)
        rows.append("\t".join([
            chroms[c[i]], str(pos[i]), "-" if minus[i] else "+",
            str(pis[i]), f"read{i % 37}", "t", str(q0), str(q1),
            str(int(q1 > q0)), "ACGTACCGTACGT"[i % 5:i % 5 + 9]]))
    return rows


def write_rows(path, rows):
    with open(path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return str(path)


def read_out(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


# ---- the call-row parser -------------------------------------------------

@pytest.mark.parametrize("seed,n,crlf", [(0, 1, False), (1, 300, False),
                                         (2, 2000, True)])
def test_parse_call_bytes_matches_jax(seed, n, crlf):
    rows = call_rows(np.random.default_rng(seed), n)
    sep = "\r\n" if crlf else "\n"
    raw = (sep.join(rows[:n // 2]) + sep + "\n" + sep.join(rows[n // 2:])
           + sep).encode()
    got, want = parse_call_bytes(raw), jax_parse(raw)
    assert len(got) == len(want) == n
    assert got.chroms == want.chroms
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert [got.kmer_at(i) for i in range(n)] == \
        [want.kmer_at(i) for i in range(n)]
    # the JAX package's plain Python parser, the reference of both; the
    # native decimal parse (both libraries') is not correctly rounded and
    # may land one ulp from Python's float()
    py = jax_cf._parse_calls_py(raw)
    assert [got.chroms[i] for i in got.chrom_ids] == \
        [py.chroms[i] for i in py.chrom_ids]
    for name in ("pos", "strand", "pos_in_strand", "label"):
        assert np.array_equal(getattr(got, name), getattr(py, name)), name
    for name in ("p0", "p1"):
        g, w = getattr(got, name), getattr(py, name)
        assert (np.abs(g - w) <= np.spacing(w)).all(), name
    assert [got.kmer_at(i) for i in range(n)] == \
        [py.kmer_at(i).rstrip("\r") for i in range(n)]


@pytest.mark.parametrize("raw", [
    b"c1\tx\t+\t1\tr\tt\t0.1\t0.9\t1\tACG\n",
    b"c1\t5\t+\t5\tr\tt\t0.1\t0.9\t1\tACG\nc1\t5\t+\t5\tr\tt\tzz\t0.9\t1\tA\n",
    b"c1\t5\t+\t5\tr\tt\t0.1\t0.9\tACG\n",
    b"no tabs here\n"])
def test_parse_call_bytes_malformed_row_raises_like_jax(raw):
    with pytest.raises(ValueError) as want:
        jax_parse(raw)
    with pytest.raises(ValueError, match="malformed call_mods row") as got:
        parse_call_bytes(raw)
    assert str(got.value) == str(want.value)


# ---- sort_segment_reduce --------------------------------------------------

def reduce_inputs(case):
    rng = np.random.default_rng(len(case))
    if case == "empty":
        n = 0
    elif case == "one row":
        n = 1
    else:
        n = {"all keys equal": 777, "random small": 37,
             "random block": 20_000}[case]
    if case == "all keys equal":
        hi, lo = np.full(n, 3), np.full(n, 123456)
    else:
        hi = rng.integers(0, 7, n)
        lo = rng.integers(0, 2**31 - 1 if n > 1000 else 9, n)
    met = rng.integers(0, 2, n)
    return [a.astype(np.int32) for a in (hi, lo, met)]


@pytest.mark.parametrize("case", ["empty", "one row", "all keys equal",
                                  "random small", "random block"])
def test_sort_segment_reduce_matches_jax(case):
    hi, lo, met = reduce_inputs(case)
    got = sort_segment_reduce(hi, lo, met, "cpu")
    want = jax_reduce(hi, lo, met)
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g, w)
    if len(hi):
        assert got[2].sum() == len(hi) and got[3].sum() == met.sum()


def test_sort_segment_reduce_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    one = np.zeros(1, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sort_segment_reduce(one, one, one)


# ---- the accumulator and the CLI -----------------------------------------

@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    d = tmp_path_factory.mktemp("calls")
    rng = np.random.default_rng(11)
    a = write_rows(d / "a.call_mods.tsv", call_rows(rng, 4000))
    b = write_rows(d / "b.call_mods.tsv", call_rows(rng, 1500))
    write_rows(d / "other.txt", call_rows(rng, 50, chroms=["ChrM"]))
    return {"dir": str(d), "a": a, "b": b}


def run_both(tmp_path, argv, port_extra=()):
    """The same call_freq argv through the JAX CLI and the port's CLI
    (on the CPU); returns the two outputs' bytes."""
    outs = []
    for side, main, extra in (("jax", jax_main, ()),
                              ("port", cli.main,
                               ("--device", "cpu", *port_extra))):
        out = str(tmp_path / f"{side}.freq.tsv")
        main(["call_freq", *argv, "-o", out, *extra])
        outs.append(read_out(out + ".gz" if "--gzip" in argv else out))
    return outs


@pytest.mark.parametrize("device_agg", [False, True],
                         ids=["host", "device_agg"])
@pytest.mark.parametrize("is_sort", [False, True], ids=["unsorted", "sort"])
@pytest.mark.parametrize("is_bed", [False, True], ids=["tsv", "bed"])
def test_call_freq_cli_matches_jax(tmp_path, calls, is_bed, is_sort,
                                   device_agg):
    argv = ["-i", calls["a"], "--prob_cf", "0.2"]
    argv += ["--bed"] * is_bed + ["--sort"] * is_sort
    argv += ["--device_agg"] * device_agg
    want, got = run_both(tmp_path, argv)
    assert want and got == want


@pytest.mark.parametrize("name,argv", [
    ("gzip", ["--sort", "--gzip"]),
    ("several inputs", ["--sort", "-i", "B"]),
    ("directory and file_uid", ["--file_uid", "call_mods"]),
    ("contigs list", ["--contigs", "Chr2,Chr10,ChrC", "--bed"]),
    ("contigs file", ["--contigs", "NAMES", "--sort"]),
    ("contigs fasta", ["--contigs", "FASTA", "--gzip"]),
    ("contig-parallel workers", ["--contigs", "FASTA", "--nproc", "2",
                                 "--sort"]),
])
@pytest.mark.parametrize("device_agg", [False, True],
                         ids=["host", "device_agg"])
def test_call_freq_cli_flags_match_jax(tmp_path, calls, name, argv,
                                       device_agg):
    names = tmp_path / "contigs.txt"
    names.write_text("Chr2\nscaffold_9\nChr2\n")
    fasta = write_fasta(str(tmp_path / "ref.fa"),
                        {c: "ACGT" * 5 for c in CHROMS[1:]})
    subst = {"B": calls["b"], "NAMES": str(names), "FASTA": fasta}
    argv = [subst.get(a, a) for a in argv]
    inp = calls["dir"] if name.startswith("directory") else calls["a"]
    argv = ["-i", inp, "--prob_cf", "0.3", *argv]
    if device_agg:
        argv.append("--device_agg")
    want, got = run_both(tmp_path, argv)
    assert want and got == want


def test_call_freq_positions_past_int32_take_the_host_path(tmp_path):
    """Blocks with positions past 2**31-1 go to the host path (as in the
    JAX package); the blocks before them in the same file go to the
    device; the output equals the JAX CLI's."""
    rng = np.random.default_rng(5)
    rows = call_rows(rng, 600, n_pos=60)
    rows += call_rows(rng, 600, pos_base=2**31 + 7, n_pos=60)
    path = write_rows(tmp_path / "big.tsv", rows)
    acc = port_cf.FreqAccumulator(prob_cf=0.0, device_agg=True,
                                  device="cpu")
    seen = []
    real = port_cf.FreqAccumulator._add_rows_device
    acc._add_rows_device = lambda cb, g, r: (seen.append(len(r)),
                                             real(acc, cb, g, r))
    acc.add_file(path, block_bytes=os.path.getsize(path) // 4)
    assert seen and sum(seen) < len(rows)
    assert int(acc._pos[:acc.n_sites].max()) >= 2**31
    port_cf.write_freq(acc, str(tmp_path / "acc.tsv"), True, False, False)
    want, got = run_both(tmp_path, ["-i", path, "--sort", "--prob_cf", "0",
                                    "--device_agg"])
    assert got == want == read_out(tmp_path / "acc.tsv")


@pytest.mark.parametrize("block_bytes", [1 << 10, 1 << 14])
@pytest.mark.parametrize("contig", [None, "Chr10"])
def test_accumulator_multiblock_matches_jax(tmp_path, calls, block_bytes,
                                            contig):
    """Small byte blocks (sites spanning blocks): the port's host and
    device accumulators against the JAX package's host accumulator."""
    want = jax_cf.FreqAccumulator(prob_cf=0.2, contig=contig)
    want.add_file(calls["a"], block_bytes=block_bytes)
    jax_cf.write_freq(want, str(tmp_path / "want.tsv"), False, False, False)
    for dev in (False, True):
        acc = port_cf.FreqAccumulator(prob_cf=0.2, contig=contig,
                                      device_agg=dev, device="cpu")
        acc.add_file(calls["a"], block_bytes=block_bytes)
        assert (acc.count, acc.used, acc.n_sites) == \
            (want.count, want.used, want.n_sites)
        assert acc.report() == want.report()
        port_cf.write_freq(acc, str(tmp_path / "got.tsv"), False, False,
                           False)
        assert read_out(tmp_path / "got.tsv") == \
            read_out(tmp_path / "want.tsv")


def test_device_agg_off_under_contig_parallel_workers(tmp_path, calls,
                                                      capsys):
    out = str(tmp_path / "x.tsv")
    cli.main(["call_freq", "-i", calls["a"], "-o", out, "--contigs",
              "Chr1,Chr2", "--nproc", "2", "--device_agg"])
    assert "[warn] --device_agg is disabled under contig-parallel " \
        "workers" in capsys.readouterr().out
    assert os.path.getsize(out) > 0


def test_call_freq_needs_no_card_without_device_agg(tmp_path, calls):
    """Host aggregation runs without --device, here where there is no
    card; --device_agg without --device asks for the card."""
    import torch
    out = str(tmp_path / "x.tsv")
    cli.main(["call_freq", "-i", calls["a"], "-o", out])
    assert os.path.getsize(out) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["call_freq", "-i", calls["a"], "-o", out,
                      "--device_agg"])


@pytest.mark.parametrize("how", ["flag", "torch env", "jax env"])
def test_pod_mode_is_refused(tmp_path, calls, monkeypatch, how):
    argv = ["call_freq", "-i", calls["a"], "-o", str(tmp_path / "x.tsv")]
    if how == "flag":
        argv += ["--pod_shard_inputs", "always"]
    elif how == "torch env":
        monkeypatch.setenv("WORLD_SIZE", "2")
    else:
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="not yet ported"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "x.tsv")
