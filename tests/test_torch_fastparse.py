"""The port's native features-TSV codecs (deepsignal_plant_tpu_torch
native/featparse.cpp, utils/fastparse.py, io/batching.py) against the JAX
package's (deepsignal_plant_tpu.utils.fastparse) on the same bytes, and
against the port's plain Python codecs (utils/formats.py).

Gate: bitwise. Both libraries compile the same C++ for the same host, so
every array and every output byte must be equal; the float32 parse must
equal the Python parse (float(str) cast to float32) bit for bit.
"""
import gzip
import os
import stat
import threading

import numpy as np
import pytest

from deepsignal_plant_tpu.io import batching as jax_batching
from deepsignal_plant_tpu.io.fast5 import read_tombo_fast5
from deepsignal_plant_tpu.pipeline.extract import (ExtractContext,
                                                   ExtractOptions,
                                                   extract_read_features,
                                                   features_to_rows)
from deepsignal_plant_tpu.utils import fastparse as jax_fp
from deepsignal_plant_tpu.utils.fileio import get_fast5s
from deepsignal_plant_tpu_torch import native
from deepsignal_plant_tpu_torch.io import batching
from deepsignal_plant_tpu_torch.io.dataset import FeatureDataset
from deepsignal_plant_tpu_torch.utils import fastparse as fp
from deepsignal_plant_tpu_torch.utils.formats import (format_call_rows,
                                                      parse_feature_lines)
from make_synthetic import (synth_fast5_dir, synth_feature_rows,
                            synth_genome, write_fasta)

ARRAYS = ("kmer", "base_means", "base_stds", "base_signal_lens", "signals",
          "labels")


def read_structured_rows(tmp_dir, n_reads=6, read_len=150, seed=1234):
    """Rows of a dense-motif (C) extraction by the JAX package from a
    synthetic resquiggled fast5 dir, in extraction order: adjacent sites
    of a read share most of their window bases."""
    rng = np.random.default_rng(seed)
    genome = synth_genome(rng, {"chr1": 3000})
    fasta = write_fasta(os.path.join(tmp_dir, "ref.fa"), genome)
    f5dir = os.path.join(tmp_dir, "f5")
    synth_fast5_dir(f5dir, genome, rng, n_reads=n_reads, read_len=read_len)
    ctx = ExtractContext.build(ExtractOptions(motifs="C",
                                              reference_path=fasta))
    rows = []
    for p in sorted(get_fast5s(f5dir, True)):
        f = extract_read_features(read_tombo_fast5(p), ctx)
        if f is not None:
            rows.extend(features_to_rows(f))
    return rows


@pytest.fixture(scope="module")
def dense_rows(tmp_path_factory):
    rows = read_structured_rows(str(tmp_path_factory.mktemp("dense")))
    assert len(rows) > 100
    return rows


@pytest.fixture(scope="module")
def blocks(dense_rows):
    """Byte blocks: sparse synthetic rows, the dense extraction in order,
    and the dense extraction shuffled."""
    sparse = synth_feature_rows(np.random.default_rng(3), n_reads=5,
                                sites_per_read=11)
    shuffled = list(np.random.default_rng(4).permutation(dense_rows))
    return {name: ("\n".join(rows) + "\n").encode()
            for name, rows in (("sparse", sparse), ("dense", dense_rows),
                               ("shuffled", shuffled))}


BLOCKS = ("sparse", "dense", "shuffled")


@pytest.mark.parametrize("name", BLOCKS)
@pytest.mark.parametrize("out_dtype", ["float32", "float16"])
def test_parse_feature_bytes_matches_jax(blocks, name, out_dtype):
    got = fp.parse_feature_bytes(blocks[name], out_dtype=out_dtype)
    want = jax_fp.parse_feature_bytes(blocks[name], out_dtype=out_dtype)
    assert got.sampleinfo == want.sampleinfo
    for k in ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("name", BLOCKS)
def test_float32_parse_matches_the_python_parse(blocks, name):
    block = blocks[name]
    got = fp.parse_feature_bytes(block)
    want = parse_feature_lines(block.decode().splitlines(True))
    assert got.sampleinfo == want.sampleinfo
    for k in ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("name", BLOCKS)
def test_raw_block_spans_and_arrays_match_jax(blocks, name):
    got = fp.parse_raw_feature_block(blocks[name])
    want = jax_fp.parse_raw_feature_block(blocks[name])
    assert got.raw is blocks[name] and got.n == want.n
    for k in ("row_starts", "info_ends", "kmer", "means", "stds", "slens",
              "signals", "labels"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("name", BLOCKS)
def test_pack_raw_block_matches_jax(blocks, name):
    """Codes, means, stds, lens, rect and centres of the read-packed wire,
    in extraction order and shuffled; windows gathered back from the
    packed axis equal the parsed rows."""
    rb = fp.parse_raw_feature_block(blocks[name])
    got = fp.pack_raw_block(rb)
    want = jax_fp.pack_raw_block(jax_fp.parse_raw_feature_block(
        blocks[name]))
    for k in ("codes", "means", "stds", "lens", "rect", "centers"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    win = got.window_index()
    for packed, rows in ((got.codes, rb.kmer), (got.means, rb.means),
                         (got.stds, rb.stds), (got.lens, rb.slens),
                         (got.rect, rb.signals)):
        assert packed[win].tobytes() == rows.tobytes()
    # extraction order dedups (~3 bases a site); shuffled rows rarely
    # follow their neighbour; random windows share nothing
    if name == "dense":
        assert got.n_bases < 8 * got.n
    elif name == "shuffled":
        assert got.n_bases > 12 * got.n
    else:
        assert got.n_bases == 13 * got.n


@pytest.mark.parametrize("name", BLOCKS)
def test_emitted_rows_match_jax(blocks, name):
    """dsp_emit_call_rows and format_call_block give the JAX package's
    bytes, and the plain Python formatter's text."""
    rb = fp.parse_raw_feature_block(blocks[name])
    rng = np.random.default_rng(5)
    probs = rng.dirichlet([1, 1], size=rb.n).astype(np.float32)
    probs[:3] = [[1, 0], [0.5, 0.5], [1e-6, 1 - 1e-6]]   # edge cases
    got = fp.emit_call_rows_arrays(rb.raw, rb.row_starts, rb.info_ends,
                                   rb.kmer, probs)
    assert got == jax_fp.emit_call_rows(
        jax_fp.parse_raw_feature_block(blocks[name]), 0, rb.n, probs)
    lo, hi = 2, rb.n - 1
    assert fp.emit_call_rows_arrays(
        rb.raw, rb.row_starts[lo:hi], rb.info_ends[lo:hi], rb.kmer[lo:hi],
        probs[lo:hi]) == got.split(b"\n", lo)[-1].rsplit(b"\n", 2)[0] + b"\n"
    fb = fp.parse_feature_bytes(blocks[name])
    text = fp.format_call_block(fb.sampleinfo, probs, fb.kmer)
    assert text == jax_fp.format_call_block(fb.sampleinfo, probs, fb.kmer)
    assert text.encode() == got
    plain = format_call_rows(fb.sampleinfo, fb.kmer, probs[:, 0],
                             probs[:, 1])
    assert text == "\n".join(plain) + "\n"


MALFORMED = {
    "label": lambda ln: ln.rsplit("\t", 1)[0] + "\tx\n",
    "info": lambda ln: ln.replace("\t", " ", 3),
    "short": lambda ln: "\t".join(ln.split("\t")[:9]) + "\n",
    "separator": lambda ln: ln.replace(",", ";", 1),
}


@pytest.mark.parametrize("how", sorted(MALFORMED))
def test_malformed_row_names_its_line(blocks, how):
    """The same error, naming the same line, as the JAX parser."""
    lines = blocks["sparse"].decode().splitlines(True)
    lines[7] = MALFORMED[how](lines[7])
    block = "".join(lines).encode()
    for name in ("parse_feature_bytes", "parse_raw_feature_block"):
        with pytest.raises(ValueError) as got:
            getattr(fp, name)(block)
        with pytest.raises(ValueError) as want:
            getattr(jax_fp, name)(block)
        assert str(got.value) == str(want.value)
        assert str(got.value).endswith("line 7")


@pytest.mark.parametrize("block", [b"", b"\n", b"\n\n"])
def test_empty_block(block):
    fb = fp.parse_feature_bytes(block)
    assert len(fb) == 0 and fb.signals.shape == (0, 13, 16)
    rb = fp.parse_raw_feature_block(block)
    pb = fp.pack_raw_block(rb)
    assert rb.n == pb.n == pb.n_bases == 0
    assert fp.emit_call_rows_arrays(rb.raw, rb.row_starts, rb.info_ends,
                                    rb.kmer, np.zeros((0, 2),
                                                      np.float32)) == b""


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("block_bytes", [1 << 20, 997])
def test_iter_byte_blocks_matches_jax(blocks, tmp_path, gz, block_bytes):
    """Newline-aligned blocks of a plain or gzip file, with a block size
    that splits rows (997 bytes: shorter than a row, so blocks carry
    over)."""
    data = blocks["dense"][:200_000]
    data = data[:data.rfind(b"\n") + 1] + b"chr1\tlast\tno-newline"
    path = str(tmp_path / ("f.tsv.gz" if gz else "f.tsv"))
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(data)
    got = list(batching.iter_byte_blocks(path, block_bytes))
    assert got == list(jax_batching.iter_byte_blocks(path, block_bytes))
    assert b"".join(got) == data
    assert all(b.endswith(b"\n") for b in got[:-1])


@pytest.mark.parametrize("device_batch", [64, 1000])
def test_batches_from_features_file_match_jax(blocks, tmp_path,
                                              device_batch):
    """The same rows in the same batches as the JAX package's, without
    its padding of the last batch; parsed by several threads."""
    path = tmp_path / "f.tsv"
    path.write_bytes(blocks["dense"] + blocks["sparse"])
    got = list(batching.batches_from_features_file(
        str(path), device_batch, parse_workers=3))
    want = list(jax_batching.batches_from_features_file(
        str(path), device_batch, parse_workers=3))
    assert [len(g) for g in got] == [w.n_valid for w in want]
    for g, w in zip(got, want):
        n = w.n_valid
        assert g.sampleinfo == w.features.sampleinfo
        for k in ARRAYS:
            assert getattr(g, k).tobytes() == \
                getattr(w.features, k)[:n].tobytes(), k


def test_bounded_thread_map_keeps_order():
    out = list(batching.bounded_thread_map(lambda x: x * x, range(50),
                                           workers=4, depth=3))
    assert out == [x * x for x in range(50)]


@pytest.mark.parametrize("taken", [0, 3, 1000])
def test_prefetch_close_stops_the_producer(taken):
    """close() after ``taken`` items (none, some, past the end) ends the
    prefetch thread and the parse map's workers, whose queues were full,
    and runs the producer generator's own clean-up."""
    before = set(threading.enumerate())
    closed = []

    def produce():
        try:
            yield from batching.bounded_thread_map(lambda x: x, range(200),
                                                   workers=3, depth=6)
        finally:
            closed.append(True)

    it = batching.PrefetchIterator(produce(), depth=2)
    got = [x for _, x in zip(range(taken), it)]
    it.close()
    assert got == list(range(min(taken, 200)))
    assert closed == [True]
    assert [t for t in threading.enumerate() if t not in before] == []


def test_dataset_parse_equals_the_python_parse(blocks, tmp_path):
    """FeatureDataset.from_file (native, in byte blocks that split the
    file) holds the plain Python parse's arrays bit for bit."""
    path = tmp_path / "f.tsv"
    path.write_bytes(blocks["sparse"] + blocks["shuffled"])
    ds = FeatureDataset.from_file(str(path), block_bytes=5000)
    want = parse_feature_lines(
        (blocks["sparse"] + blocks["shuffled"]).decode().splitlines(True))
    for k in ARRAYS:
        a, b = getattr(ds, k), getattr(want, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_library_builds_without_march_native():
    """One build for every x86-64 host: the flags name no host CPU."""
    assert not any(f.startswith("-march") for f in native.CXX_FLAGS)
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert native.library_path().parent == native.BUILD_DIR
    assert native.load() is native.load()


def _failing_compiler(tmp_path):
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho 'featparse.cpp:1: error: no "
                      "compiler here' >&2\nexit 1\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


@pytest.mark.parametrize("cxx", ["false", "script", "no-such-compiler"])
def test_failed_build_raises_with_the_compilers_output(
        blocks, tmp_path, monkeypatch, cxx):
    """A compiler that fails makes the parser raise, with the command and
    what the compiler printed; nothing falls back to Python."""
    if cxx == "script":
        cxx = _failing_compiler(tmp_path)
    monkeypatch.setattr(native, "CXX", cxx)
    with pytest.raises(RuntimeError) as err:
        fp.parse_feature_bytes(blocks["sparse"])
    msg = str(err.value)
    assert cxx in msg
    if "/" in cxx:
        assert "error: no compiler here" in msg
    assert not native.library_path().exists()
