"""The port's tools set (deepsignal_plant_tpu_torch tools) against the
JAX package's tools on the same inputs, on the CPU: every output file
byte-identical (gzip compared decompressed), as tests/test_tools_bed.py
and tests/test_tools_extra.py exercise them. Tools that draw random
numbers get the same seeded generator on both sides; convert_ckpt
round-trips both ways with arrays equal to the JAX tool's.
"""
import gzip
import os
import pickle
import random

import jax
import numpy as np
import pytest
import torch

from deepsignal_plant_tpu.cli import main as jax_main
from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.models.bilstm import init_params
from deepsignal_plant_tpu.models.convert import \
    load_checkpoint as jax_load
from deepsignal_plant_tpu.models.convert import save_checkpoint
from deepsignal_plant_tpu.tools import fileops as jax_fileops
from deepsignal_plant_tpu.tools.evaluate import auroc as jax_auroc
from deepsignal_plant_tpu_torch import cli
from deepsignal_plant_tpu_torch.models.convert import load_checkpoint
from deepsignal_plant_tpu_torch.tools import fileops
from deepsignal_plant_tpu_torch.tools.evaluate import auroc
from make_synthetic import (synth_feature_rows, synth_genome,
                            write_feature_file, write_fasta)

SIDES = (("jax", jax_main), ("port", cli.main))


def _freq_row(chrom, pos, strand, p0, p1, met, unmet, kmer):
    cov = met + unmet
    rmet = met / cov if cov else 0.0
    return "%s\t%d\t%s\t%d\t%.3f\t%.3f\t%d\t%d\t%d\t%.4f\t%s" % (
        chrom, pos, strand, pos, p0, p1, met, unmet, cov, rmet, kmer)


def _call_row(chrom, pos, strand, p1, kmer):
    return "\t".join([chrom, str(pos), strand, str(pos), "r1", "t",
                      str(round(1 - p1, 6)), str(round(p1, 6)),
                      str(int(p1 > 0.5)), kmer])


def genome_and_sites(rng):
    """A genome, and per contig a few C sites of each strand with their
    13-mers (contexts CG, CHG and CHH all present)."""
    genome = synth_genome(rng, {"NC_003070.9": 600, "NC_000932.1": 400})
    sites = []
    for chrom, seq in genome.items():
        for pos in range(8, len(seq) - 8):
            if seq[pos] == "C":
                sites.append((chrom, pos, "+", seq[pos - 6:pos + 7]))
            elif seq[pos] == "G":
                sites.append((chrom, pos, "-", seq[pos - 6:pos + 7]))
    return genome, sites


def write_inputs(d, seed=3):
    """The same inputs in directory ``d`` on each side."""
    rng = np.random.default_rng(seed)
    genome, sites = genome_and_sites(rng)
    write_fasta(str(d / "ref.fa"), genome)
    freq, bed, calls = [], [], []
    for chrom, pos, strand, kmer in sites:
        met, unmet = (int(x) for x in rng.integers(0, 6, 2))
        if met + unmet == 0:
            unmet = 1
        freq.append(_freq_row(chrom, pos, strand, rng.random() * 3,
                              rng.random() * 3, met, unmet, kmer))
        cov = met + unmet
        bed.append("\t".join([chrom, str(pos), str(pos + 1), ".", str(cov),
                              strand, str(pos), str(pos + 1), "0,0,0",
                              str(cov), str(int(100 * met / cov))]))
        calls.append(_call_row(chrom, pos, strand, float(rng.random()),
                               kmer))
    (d / "x.freq.tsv").write_text("\n".join(freq) + "\n")
    (d / "y.freq.tsv").write_text("\n".join(freq[::3]) + "\n")
    with gzip.open(d / "z.freq.tsv.gz", "wt") as fh:
        fh.write("\n".join(freq[1::2]) + "\n")
    (d / "x.freq.bed").write_text("\n".join(bed) + "\n")
    (d / "c.call_mods.tsv").write_text("\n".join(calls) + "\n")
    (d / "meth.tsv").write_text("\n".join(
        _call_row("c1", i, "+", float(p), "ACGCG")
        for i, p in enumerate(rng.beta(5, 2, 300))) + "\n")
    (d / "unmeth.tsv").write_text("\n".join(
        _call_row("c1", i, "+", float(p), "ACGCG")
        for i, p in enumerate(rng.beta(2, 5, 300))) + "\n")
    feats = synth_feature_rows(rng, 4, 12)
    write_feature_file(str(d / "f.tsv"), feats)
    (d / "pos.tsv").write_text("\n".join(
        "\t".join(r.split("\t")[:2]) for r in feats[::5]) + "\n")
    (d / "x.gff3").write_text("\n".join([
        "##gff-version 3",
        "c1\tsrc\tgene\t1\t100\t.\t+\t.\tID=gene:G1",
        "c1\tsrc\tmRNA\t1\t100\t.\t+\t.\tID=transcript:T1;Parent=gene:G1",
        "c1\tsrc\texon\t1\t10\t.\t+\t.\tParent=transcript:T1;rank=1",
        "c1\tsrc\texon\t21\t30\t.\t+\t.\tParent=transcript:T1;rank=2",
        "c1\tsrc\tmRNA\t1\t50\t.\t-\t.\tID=transcript:T2;Parent=gene:G1",
        "c1\tsrc\texon\t1\t10\t.\t-\t.\tParent=transcript:T2;rank=1",
        "c1\tsrc\texon\t31\t40\t.\t-\t.\tParent=transcript:T2;rank=2",
    ]) + "\n")


def tree(d):
    """{relative path: content} of every file under ``d``; gzip files
    decompressed, pickles loaded."""
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            if f.endswith(".gz"):
                with gzip.open(p, "rb") as fh:
                    out[os.path.relpath(p, d)] = fh.read()
            elif f.endswith(".pkl"):
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, d)] = pickle.load(fh)
            else:
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, d)] = fh.read()
    return out


TOOL_ARGS = {
    "split_freq_by_motif tsv": ["split_freq_by_motif", "--freqfile",
                                "D/x.freq.tsv"],
    "split_freq_by_motif bed": ["split_freq_by_motif", "--freqfile",
                                "D/x.freq.bed", "--ref", "D/ref.fa"],
    "split_call_mods_by_motif": ["split_call_mods_by_motif",
                                 "--callmods_file", "D/c.call_mods.tsv"],
    "combine_freq_files": ["combine_freq_files", "--modspath", "D",
                           "--file_uid", ".freq.tsv", "--wfile",
                           "D/comb.tsv"],
    "combine_freq_files sort bed": [
        "combine_freq_files", "--modspath", "D/x.freq.tsv", "--modspath",
        "D/y.freq.tsv", "--wfile", "D/comb.bed", "--sort", "--bed"],
    "combine_strands_freq tsv": ["combine_strands_freq", "--frequency_fp",
                                 "D/x.freq.tsv", "-r", "D/ref.fa"],
    "combine_strands_freq bed": ["combine_strands_freq", "--frequency_fp",
                                 "D/x.freq.bed", "-r", "D/ref.fa",
                                 "--contig", "NC_003070.9"],
    "freq2bed": ["freq2bed", "--freqfile", "D/x.freq.tsv", "--covcf", "3"],
    "freq2bed conv_chrom sort": ["freq2bed", "--freqfile", "D/x.freq.tsv",
                                 "--wfile", "D/o.bed", "--conv_chrom",
                                 "--sort"],
    "evaluate_calls": ["evaluate_calls", "--methylated", "D/meth.tsv",
                       "--unmethylated", "D/unmeth.tsv", "--result_file",
                       "D/eval.tsv", "--seed", "7"],
    "filter_by_positions": ["filter_by_positions", "--sf_path", "D/f.tsv",
                            "-p", "D/pos.tsv", "--label", "0"],
    "filter_by_positions dir": ["filter_by_positions", "--sf_path", "D",
                                "--unique_fid", "f.tsv", "-p",
                                "D/pos.tsv"],
    "filter_by_label": ["filter_by_label", "--sf_fp", "D/f.tsv",
                        "--label", "1"],
    "contig_names": ["contig_names", "--ref_fp", "D/ref.fa", "--wfp",
                     "D/contigs.txt"],
    "gff_map": ["gff_map", "--gff", "D/x.gff3", "--out_pkl", "D/m.pkl"],
}


@pytest.mark.parametrize("case", sorted(TOOL_ARGS))
def test_tool_output_matches_jax(tmp_path, case):
    trees = []
    for side, main in SIDES:
        d = tmp_path / side
        d.mkdir()
        write_inputs(d)
        before = tree(d)
        main(["tools", *[a.replace("D", str(d)) if a.startswith("D")
                         else a for a in TOOL_ARGS[case]]])
        t = tree(d)
        assert t != before, f"{case} wrote nothing on the {side} side"
        trees.append(t)
    assert trees[1].keys() == trees[0].keys()
    for k in trees[0]:
        assert trees[1][k] == trees[0][k], k


@pytest.mark.parametrize("case", ["shuffle_file", "shuffle_file header",
                                  "concat_files", "randsel_rows"])
def test_seeded_tool_output_matches_jax(tmp_path, case):
    """The shuffling and sampling tools with the same seeded generator
    on both sides (their CLIs draw unseeded numbers)."""
    outs = []
    for side, mod in (("jax", jax_fileops), ("port", fileops)):
        d = tmp_path / side
        d.mkdir()
        write_inputs(d)
        out = str(d / "out.tsv")
        if case.startswith("shuffle_file"):
            mod.shuffle_big_file(str(d / "x.freq.tsv"), out, 17,
                                 header=case.endswith("header"),
                                 rng=np.random.default_rng(5))
        elif case == "concat_files":
            mod.shuffle_concat(str(d / "x.freq.tsv"), str(d / "y.freq.tsv"),
                               out, 13, rng=np.random.default_rng(5))
        else:
            assert mod.randsel_rows(str(d / "f.tsv"), out, 20,
                                    rng=random.Random(5)) == 20
        outs.append(open(out, "rb").read())
    assert outs[0] and outs[1] == outs[0]


def test_auroc_matches_jax(rng):
    y = rng.integers(0, 2, 500)
    s = rng.random(500)
    assert auroc(y, s) == jax_auroc(y, s)
    s_t = np.round(s, 1)
    assert auroc(y, s_t) == jax_auroc(y, s_t)
    assert auroc(np.ones(5), s[:5]) == jax_auroc(np.ones(5), s[:5]) == 0.0


@pytest.fixture(scope="module")
def narrow_ckpt(tmp_path_factory):
    cfg = JaxModelConfig(hidden_size=32, num_layers_comb=2)
    path = str(tmp_path_factory.mktemp("ckpt") / "m.ckpt.npz")
    save_checkpoint(path, init_params(jax.random.PRNGKey(3), cfg), cfg)
    return path


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: np.asarray(tree)}


NARROW = ["--hid_rnn", "32", "--layernum1", "2"]


def test_convert_ckpt_round_trips_like_jax(tmp_path, narrow_ckpt):
    """.npz -> torch .ckpt -> .npz through each package's tool: the torch
    state dicts are equal, and both round trips give back the original
    arrays; each package's .ckpt converts through the other's tool."""
    sds, back = [], []
    for side, main in SIDES:
        pt = str(tmp_path / f"{side}.ckpt")
        main(["tools", "convert_ckpt", "-m", narrow_ckpt, "-o", pt,
              "--direction", "to_torch", *NARROW])
        sds.append(torch.load(pt, weights_only=True))
        npz = str(tmp_path / f"{side}.back")
        main(["tools", "convert_ckpt", "-m", pt, "-o", npz,
              "--direction", "to_npz", *NARROW])
        back.append(_flat(load_checkpoint(npz + ".npz")[0]))
    assert sds[0].keys() == sds[1].keys()
    for k in sds[0]:
        assert torch.equal(sds[0][k], sds[1][k]), k
    orig = _flat(jax_load(narrow_ckpt)[0])
    for b in back:
        assert b.keys() == orig.keys()
        for k in orig:
            np.testing.assert_allclose(b[k], orig[k], rtol=0, atol=0,
                                       err_msg=k)
    # across packages: the JAX tool's .ckpt through the port's tool and
    # the port's .ckpt through the JAX tool
    for src, main, name in (("jax", cli.main, "x1"),
                            ("port", jax_main, "x2")):
        out = str(tmp_path / name)
        main(["tools", "convert_ckpt", "-m", str(tmp_path / f"{src}.ckpt"),
              "-o", out, *NARROW])
        got = _flat(jax_load(out + ".npz")[0])
        for k in orig:
            np.testing.assert_allclose(got[k], orig[k], rtol=0, atol=0,
                                       err_msg=k)
