"""Split freq / call_mods files by 5mC context (CG / CHG / CHH; copy of
deepsignal_plant_tpu/tools/splitters.py).

Parity: scripts/split_freq_file_by_5mC_motif.py and
scripts/split_callmods_file_by_5mC_motif.py — the 3-base context right of
the cytosine decides the bucket; for .bed inputs the context comes from a
reference-genome lookup (fwd: seq[pos:pos+3]; rev: complement of
seq[pos-2:pos+1])."""
from __future__ import annotations

import os

from ..utils.bases import complement_seq
from ..utils.fasta import DNAReference
from ..utils.formats import open_text
from ..utils.motifs import expand_iupac_motif

CONTEXTS = ("CGN", "CHG", "CHH")


def context_seq_map() -> dict[str, str]:
    """concrete 3-mer (or degenerate original) -> context bucket
    (split_freq_file_by_5mC_motif.py:79-89)."""
    seq2ctx: dict[str, str] = {}
    for ctx in CONTEXTS:
        for seq in expand_iupac_motif(ctx):
            seq2ctx[seq] = ctx
        seq2ctx[ctx] = ctx
    return seq2ctx


def _out_name(base_path: str, ctx: str) -> str:
    motifstr = "CG" if ctx.startswith("CG") else ctx
    fname, fext = os.path.splitext(base_path)
    if fname.endswith(".freq"):
        return fname[:-len(".freq")] + "." + motifstr + ".freq" + fext
    if fname.endswith(".frequency"):
        return fname[:-len(".frequency")] + "." + motifstr + \
            ".frequency" + fext
    return fname + "." + motifstr + fext


def motifseq_from_ref(contigs: dict[str, str], chrom: str, pos: int,
                      strand: str) -> str:
    if strand == "+":
        return contigs[chrom][pos:pos + 3]
    return complement_seq(contigs[chrom][pos - 2:pos + 1])


def split_freq_file(freqfile: str, ref: str | None) -> tuple[int, int]:
    """Returns (total, failed) line counts."""
    seq2ctx = context_seq_map()
    wfs = {ctx: open(_out_name(freqfile, ctx), "w") for ctx in CONTEXTS}
    count = fails = 0
    is_bed = os.path.splitext(freqfile)[1].endswith(".bed")
    contigs = None
    if is_bed:
        if ref is None:
            raise ValueError("--ref must be provided if freqfile is .bed!")
        contigs = DNAReference(ref).getcontigs()
    try:
        with open_text(freqfile) as rf:
            for line in rf:
                count += 1
                words = line.strip().split("\t")
                if is_bed:
                    seq = motifseq_from_ref(contigs, words[0], int(words[1]),
                                            words[5])
                else:
                    kmer = words[-1]
                    cen = len(kmer) // 2
                    seq = kmer[cen:cen + 3]
                ctx = seq2ctx.get(seq)
                if ctx is None:
                    fails += 1
                    print("seq: {}, line: {}".format(seq, line.strip()))
                else:
                    wfs[ctx].write(line)
    finally:
        for wf in wfs.values():
            wf.close()
    print("total lines: {}, failed lines: {}".format(count, fails))
    return count, fails


def split_callmods_file(callmods_file: str) -> tuple[int, int]:
    """Split a call_mods TSV by the center 3-mer of its k-mer column
    (split_callmods_file_by_5mC_motif.py:66-107)."""
    seq2ctx = context_seq_map()
    base = callmods_file[:-3] if callmods_file.endswith(".gz") \
        else callmods_file
    fname, fext = os.path.splitext(base)
    wfs = {ctx: open(fname + "." + ("CG" if ctx.startswith("CG") else ctx)
                     + fext, "w") for ctx in CONTEXTS}
    count = fails = 0
    try:
        with open_text(callmods_file) as rf:
            for line in rf:
                count += 1
                kmer = line.strip().split("\t")[-1]
                cen = len(kmer) // 2
                seq = kmer[cen:cen + 3]
                ctx = seq2ctx.get(seq)
                if ctx is None:
                    fails += 1
                    print("seq: {}, line: {}".format(seq, line.strip()))
                else:
                    wfs[ctx].write(line)
    finally:
        for wf in wfs.values():
            wf.close()
    print("total lines: {}, failed lines: {}".format(count, fails))
    return count, fails


def register(tool_sub) -> None:
    p = tool_sub.add_parser("split_freq_by_motif",
                            description="split a freq tsv/bed into "
                                        "CG/CHG/CHH context files")
    p.add_argument("--freqfile", type=str, required=True)
    p.add_argument("--ref", type=str, required=False, default=None)
    p.set_defaults(func=lambda a: split_freq_file(a.freqfile, a.ref))

    p = tool_sub.add_parser("split_call_mods_by_motif",
                            description="split a call_mods tsv into "
                                        "CG/CHG/CHH context files")
    p.add_argument("--callmods_file", type=str, required=True)
    p.set_defaults(func=lambda a: split_callmods_file(a.callmods_file))
