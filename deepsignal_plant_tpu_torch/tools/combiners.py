"""Combine freq outputs: across files, and across +/- strands of CpG sites
(copy of deepsignal_plant_tpu/tools/combiners.py).

Parity: scripts/combine_call_mods_freq_files.py (per-site sums over
multiple freq files) and scripts/combine_two_strands_frequency.py (merge
both strands of palindromic CG sites onto the forward-strand position).
Also freq->bedMethyl conversion (scripts/freq2bedmethyl.py) with its
A. thaliana chromosome renaming map.
"""
from __future__ import annotations

import os

from ..utils.fasta import DNAReference
from ..utils.formats import format_freq_row, open_text
from ..utils.motifs import motif_locs_in_seq

# RefSeq -> TAIR chromosome names (freq2bedmethyl.py:6-12)
CHROMNAME_MAP_ARAB = {
    "NC_003070.9": "Chr1", "NC_003071.7": "Chr2", "NC_003074.8": "Chr3",
    "NC_003075.7": "Chr4", "NC_003076.8": "Chr5", "NC_037304.1": "ChrM",
    "NC_000932.1": "ChrC",
}


def combine_freq_files(modsfiles: list[str], wfile: str, is_sort: bool,
                       is_bed: bool) -> None:
    """Sum per-site stats over freq files; last file wins for
    pos_in_strand/kmer (combine_call_mods_freq_files.py:25-42)."""
    freqinfo: dict[tuple, list] = {}
    for ffile in modsfiles:
        with open_text(ffile) as rf:
            for line in rf:
                w = line.strip().split("\t")
                key = (w[0], int(w[1]), w[2])
                info = freqinfo.setdefault(
                    key, [-1, 0.0, 0.0, 0, 0, 0, 0.0, "-"])
                info[0] = int(w[3])
                info[1] += float(w[4])
                info[2] += float(w[5])
                info[3] += int(w[6])
                info[4] += int(w[7])
                info[5] += int(w[8])
                info[6] = info[3] / float(info[5])
                info[7] = w[10]
    keys = sorted(freqinfo.keys()) if is_sort else list(freqinfo.keys())
    with open(wfile, "w") as wf:
        for key in keys:
            chrom, pos, strand = key
            pis, p0, p1, met, unmet, cov, rmet, kmer = freqinfo[key]
            if is_bed:
                # note: this combiner's bed rounding has no +0.001 nudge
                # (combine_call_mods_freq_files.py:57)
                wf.write("\t".join([chrom, str(pos), str(pos + 1), ".",
                                    str(cov), strand, str(pos), str(pos + 1),
                                    "0,0,0", str(cov),
                                    str(int(round(rmet * 100, 0)))]) + "\n")
            else:
                wf.write(format_freq_row(chrom, pos, strand, pis, p0, p1,
                                         met, unmet, cov, rmet, kmer) + "\n")


def _genome_cg_positions(ref_fp: str, contig: str = "") -> set[tuple]:
    contigs = DNAReference(ref_fp).getcontigs()
    names = [contig] if contig else list(contigs.keys())
    poses = set()
    for name in names:
        for p in motif_locs_in_seq(contigs[name], ["CG"], 0):
            poses.add((name, p))
    return poses


def combine_strands_freq(report_fp: str, ref_fp: str, contig: str = ""
                         ) -> str:
    """Merge both strands of each genome CpG onto the forward position;
    writes <name>.fb_combined<ext> and returns its path
    (combine_two_strands_frequency.py:50-129)."""
    cgposes = _genome_cg_positions(ref_fp, contig)
    fname, fext = os.path.splitext(report_fp)
    wfp = fname + ".fb_combined" + fext
    is_bed = str(report_fp).lower().endswith(".bed")

    if not is_bed:
        pos2info: dict[tuple, list] = {c: [0.0, 0.0, 0, 0, 0, 0.0, "-"]
                                       for c in cgposes}
        with open_text(report_fp) as rf:
            for line in rf:
                w = line.strip().split("\t")
                key = (w[0], int(w[1]))
                if w[2] == "-":
                    key = (w[0], int(w[1]) - 1)
                    if key not in cgposes:
                        print("{}, not in selected motif poses of the "
                              "genome".format(w))
                        continue
                else:
                    if key not in cgposes:
                        print("{}, not in selected motif poses of the "
                              "genome".format(w))
                        continue
                    pos2info[key][6] = w[10]
                pos2info[key][0] += float(w[4])
                pos2info[key][1] += float(w[5])
                pos2info[key][2] += int(w[6])
                pos2info[key][3] += int(w[7])
                pos2info[key][4] += int(w[8])
        rows = []
        for key, info in pos2info.items():
            if info[4] == 0:
                continue
            info[5] = float(info[2]) / info[4]
            rows.append(list(key) + ["+", key[1]] + info)
        rows.sort(key=lambda x: (x[0], x[1]))
        with open(wfp, "w") as wf:
            for r in rows:
                wf.write("\t".join(map(str, r)) + "\n")
    else:
        pos2info = {c: [0, 0.0, 0.0] for c in cgposes}
        with open_text(report_fp) as rf:
            for line in rf:
                w = line.strip().split("\t")
                key = (w[0], int(w[1]))
                if w[5] == "-":
                    key = (w[0], int(w[1]) - 1)
                if key not in cgposes:
                    print("{}, not in selected motif poses of the "
                          "genome".format(w))
                    continue
                cov = int(w[9])
                pos2info[key][0] += cov
                pos2info[key][1] += float(w[10]) / 100 * cov
        rows = []
        for key, info in pos2info.items():
            if info[0] == 0:
                continue
            info[2] = float(info[1]) / info[0]
            chrom, fpos = key
            rows.append([chrom, fpos, fpos + 1, ".", info[0], "+", fpos,
                         fpos + 1, "0,0,0", info[0],
                         int(round(info[2] + 0.000001, 2) * 100)])
        rows.sort(key=lambda x: (x[0], x[1]))
        with open(wfp, "w") as wf:
            for r in rows:
                wf.write("\t".join(map(str, r)) + "\n")
    return wfp


def freq2bed(freqfile: str, wfile: str | None, covcf: int,
             conv_chrom: bool, is_sort: bool) -> str:
    """freq TSV -> bedMethyl with a coverage cutoff (freq2bedmethyl.py:15)."""
    freqinfo: dict[tuple, tuple] = {}
    with open_text(freqfile) as rf:
        for line in rf:
            w = line.strip().split("\t")
            chrom = CHROMNAME_MAP_ARAB[w[0]] if conv_chrom else w[0]
            cov, rmet = int(w[8]), float(w[9])
            if cov >= covcf:
                freqinfo[(chrom, int(w[1]), w[2])] = (cov, rmet)
    keys = sorted(freqinfo.keys()) if is_sort else list(freqinfo.keys())
    if wfile is None:
        wfile = os.path.splitext(freqfile)[0] + ".bed"
    with open(wfile, "w") as wf:
        for chrom, pos, strand in keys:
            cov, rmet = freqinfo[(chrom, pos, strand)]
            wf.write("\t".join([chrom, str(pos), str(pos + 1), ".",
                                str(cov), strand, str(pos), str(pos + 1),
                                "0,0,0", str(cov),
                                str(int(round(rmet * 100 + 0.001, 0)))])
                     + "\n")
    return wfile


def register(tool_sub) -> None:
    from ..pipeline.call_freq import collect_mods_files

    p = tool_sub.add_parser("combine_freq_files",
                            description="merge multiple freq files per site")
    p.add_argument("--modspath", action="append", type=str, required=True)
    p.add_argument("--wfile", type=str, required=True)
    p.add_argument("--file_uid", type=str, default=None)
    p.add_argument("--sort", action="store_true", default=False)
    p.add_argument("--bed", action="store_true", default=False)
    p.set_defaults(func=lambda a: combine_freq_files(
        collect_mods_files(a.modspath, a.file_uid), a.wfile, a.sort, a.bed))

    p = tool_sub.add_parser("combine_strands_freq",
                            description="merge +/- strand CG freq onto "
                                        "forward-strand positions")
    p.add_argument("--frequency_fp", type=str, required=True)
    p.add_argument("-r", "--ref_fp", type=str, required=True)
    p.add_argument("--contig", type=str, default="")
    p.set_defaults(func=lambda a: combine_strands_freq(
        a.frequency_fp, a.ref_fp, a.contig))

    p = tool_sub.add_parser("freq2bed",
                            description="freq tsv -> bedMethyl with "
                                        "coverage cutoff")
    p.add_argument("--freqfile", type=str, required=True)
    p.add_argument("--covcf", type=int, default=1)
    p.add_argument("--wfile", type=str, default=None)
    p.add_argument("--conv_chrom", action="store_true", default=False)
    p.add_argument("--sort", action="store_true", default=False)
    p.set_defaults(func=lambda a: freq2bed(a.freqfile, a.wfile, a.covcf,
                                           a.conv_chrom, a.sort))
