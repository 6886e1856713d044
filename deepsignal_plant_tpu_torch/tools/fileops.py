"""File operations: shuffle, concat, random selection, sample filters,
contig names, GFF3 coordinate maps (copy of
deepsignal_plant_tpu/tools/fileops.py).

Parity: scripts/shuffle_a_big_file.py, concat_two_files.py,
randsel_file_rows.py, filter_samples_by_positions.py,
filter_samples_by_label.py, extract_contig_names_from_fasta.py."""
from __future__ import annotations

import os
import random

import numpy as np

from ..utils.fasta import get_contig_names
from ..utils.fileio import count_lines, shuffle_concat
from ..utils.formats import open_text


def shuffle_big_file(fp: str, out_fp: str, chunk_lines: int = 2_000_000,
                     header: bool = False,
                     rng: np.random.Generator | None = None) -> None:
    """Chunk-shuffled rewrite of a big row file
    (shuffle_a_big_file.py)."""
    rng = rng or np.random.default_rng()
    with open_text(fp) as rf, open(out_fp, "w") as wf:
        if header:
            wf.write(next(rf))
        while True:
            block = []
            for _ in range(chunk_lines):
                line = rf.readline()
                if not line:
                    break
                block.append(line)
            if not block:
                break
            for i in rng.permutation(len(block)):
                wf.write(block[i])


def randsel_rows(ori_file: str, w_file: str, num_lines: int,
                 header: bool = True,
                 rng: random.Random | None = None) -> int:
    """Random row subsample preserving order (randsel_file_rows.py)."""
    rng = rng or random
    nrows = count_lines(ori_file, header)
    take = min(num_lines, nrows)
    chosen = np.zeros(nrows, dtype=bool)
    chosen[rng.sample(range(nrows), take)] = True
    written = 0
    with open_text(ori_file) as rf, open(w_file, "w") as wf:
        if header:
            wf.write(next(rf))
        for i, line in enumerate(rf):
            if chosen[i]:
                wf.write(line)
                written += 1
    return written


def read_posfile_2cols(positionfp: str, col_chrom: int = 0,
                       col_pos: int = 1, header: bool = False) -> set[str]:
    """(chrom, pos) position keys (filter_samples_by_positions.py:11)."""
    poss = set()
    with open_text(positionfp) as rf:
        if header:
            next(rf)
        for line in rf:
            w = line.strip().split("\t")
            poss.add(" ".join([w[col_chrom], w[col_pos]]))
    return poss


def filter_features_by_positions(sf_path: str, unique_fid: str, pos_fp: str,
                                 midfix: str, label: str,
                                 chrom_col: int = 1, pos_col: int = 2
                                 ) -> list[str]:
    """Keep feature rows whose (chrom, pos) is in the positions file and
    overwrite the label column (filter_samples_by_positions.py:22-42).
    Accepts a file or a directory; returns output paths."""
    positions = read_posfile_2cols(pos_fp)
    inputs = []
    if os.path.isdir(sf_path):
        for f in os.listdir(sf_path):
            if f.find(unique_fid) != -1:
                inputs.append(os.path.join(sf_path, f))
    else:
        inputs = [sf_path]
    outs = []
    for inp in inputs:
        fname, fext = os.path.splitext(inp)
        out = fname + "." + midfix + fext
        with open_text(inp) as rf, open(out, "w") as wf:
            for line in rf:
                w = line.strip().split("\t")
                if " ".join([w[chrom_col - 1], w[pos_col - 1]]) in positions:
                    wf.write("\t".join(w[:-1] + [label]) + "\n")
        outs.append(out)
    return outs


def filter_features_by_label(sf_fp: str, wfp: str | None, label: int
                             ) -> str:
    """Keep rows whose last column equals label
    (filter_samples_by_label.py)."""
    if wfp is None:
        fname, fext = os.path.splitext(sf_fp)
        wfp = fname + ".label" + str(label) + fext
    with open_text(sf_fp) as rf, open(wfp, "w") as wf:
        for line in rf:
            if int(line.rstrip("\n").split("\t")[-1]) == label:
                wf.write(line)
    return wfp


def write_contig_names(ref_fp: str, out_fp: str) -> list[str]:
    """Contig name list for call_freq --contigs
    (extract_contig_names_from_fasta.py)."""
    names = get_contig_names(ref_fp)
    with open(out_fp, "w") as wf:
        for n in names:
            wf.write(n + "\n")
    return names


def register(tool_sub) -> None:
    p = tool_sub.add_parser("shuffle_file",
                            description="chunk-shuffle rows of a big file")
    p.add_argument("--fp", type=str, required=True)
    p.add_argument("--wfp", type=str, required=True)
    p.add_argument("--lnums_inmem", type=int, default=2_000_000)
    p.add_argument("--header", type=str, default="no")
    p.set_defaults(func=lambda a: shuffle_big_file(
        a.fp, a.wfp, a.lnums_inmem, a.header.lower() in
        ("yes", "true", "t", "1")))

    p = tool_sub.add_parser("concat_files",
                            description="shuffle-concat two row files")
    p.add_argument("--fp1", type=str, required=True)
    p.add_argument("--fp2", type=str, required=True)
    p.add_argument("--concated_fp", type=str, required=True)
    p.add_argument("--shuffle_lines_num", type=int, default=2_000_000)
    p.set_defaults(func=lambda a: shuffle_concat(
        a.fp1, a.fp2, a.concated_fp, a.shuffle_lines_num))

    p = tool_sub.add_parser("randsel_rows",
                            description="random row subsample of a file")
    p.add_argument("--ori_filepath", type=str, required=True)
    p.add_argument("--write_filepath", type=str, required=True)
    p.add_argument("--num_lines", type=int, default=10000)
    p.add_argument("--header", type=str, default="yes")
    p.set_defaults(func=lambda a: randsel_rows(
        a.ori_filepath, a.write_filepath, a.num_lines,
        a.header.lower() in ("yes", "true", "t", "1")))

    p = tool_sub.add_parser("filter_by_positions",
                            description="keep feature rows at given "
                                        "(chrom, pos) positions")
    p.add_argument("--sf_path", type=str, required=True)
    p.add_argument("--unique_fid", type=str, default=".tsv")
    p.add_argument("-p", "--pos_fp", type=str, required=True)
    p.add_argument("--midfix", type=str, default="filtered")
    p.add_argument("--label", type=str, default="1")
    p.set_defaults(func=lambda a: filter_features_by_positions(
        a.sf_path, a.unique_fid, a.pos_fp, a.midfix, a.label))

    p = tool_sub.add_parser("filter_by_label",
                            description="keep feature rows with a given "
                                        "label")
    p.add_argument("--sf_fp", type=str, required=True)
    p.add_argument("--wfp", type=str, default=None)
    p.add_argument("--label", type=int, default=1)
    p.set_defaults(func=lambda a: filter_features_by_label(
        a.sf_fp, a.wfp, a.label))

    p = tool_sub.add_parser("contig_names",
                            description="extract contig names from a fasta")
    p.add_argument("--ref_fp", type=str, required=True)
    p.add_argument("--wfp", type=str, required=True)
    p.set_defaults(func=lambda a: write_contig_names(a.ref_fp, a.wfp))

    p = tool_sub.add_parser(
        "gff_map",
        description="map transcript coordinates to genome positions from a "
                    "GFF3 (RNA support scaffolding; reference "
                    "scripts/gff_reader.py)")
    p.add_argument("--gff", type=str, required=True)
    p.add_argument("--out_pkl", type=str, required=True)

    def _gff_map(a):
        from ..utils.gff import GFF3
        GFF3(a.gff).save_coordinates_mapping(a.out_pkl)

    p.set_defaults(func=_gff_map)
