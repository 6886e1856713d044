"""GFF3 parsing + transcript->genome coordinate mapping (RNA support
scaffolding; copy of deepsignal_plant_tpu/utils/gff.py without its two
attribute helpers, which nothing calls).

Parity: scripts/gff_reader.py — a GFF3Element per non-comment row (start
converted to 0-based), gene/transcript indexing, exon grouping by parent,
and per-transcript genome-coordinate expansion honoring exon rank and
strand.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass, field


@dataclass
class GFF3Element:
    chromosome: str
    source: str
    feature: str
    start: int          # 0-based
    end: int
    score: str
    strand: str
    phase: str
    attributes: str
    attrs: dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_fields(cls, fields: list[str]) -> "GFF3Element":
        attrs = {}
        for kv in fields[8].strip().split(";"):
            if kv:
                k, _, v = kv.strip().partition("=")
                attrs[k] = v
        return cls(fields[0], fields[1], fields[2], int(fields[3]) - 1,
                   int(fields[4]), fields[5], fields[6], fields[7],
                   fields[8], attrs)

    @property
    def id(self) -> str | None:
        if "ID" in self.attrs:
            return self.attrs["ID"]
        return self.attrs.get("Name")

    @property
    def ensemblid(self) -> str | None:
        """ensembl convention: ID=transcript:XXX -> XXX
        (gff_reader.py:53-57)."""
        if "ID" in self.attrs:
            parts = self.attrs["ID"].strip().split(":")
            return parts[1] if len(parts) > 1 else parts[0]
        return self.attrs.get("Name")

    @property
    def parent(self) -> str | None:
        return self.attrs.get("Parent")

    @property
    def rank(self) -> int | None:
        return int(self.attrs["rank"]) if "rank" in self.attrs else None

    def print_str(self) -> str:
        return "\t".join([self.id or "", self.chromosome, str(self.start),
                          str(self.end), self.strand, self.feature,
                          self.attributes])


class GFF3:
    """Whole-file index: elements, feature kinds, gene/transcript ids,
    parent->exon grouping (gff_reader.py:119-154)."""

    def __init__(self, filepath: str):
        self.eles: list[GFF3Element] = []
        self.features: set[str] = set()
        self.gt2idx: dict[str, int] = {}
        with open(filepath) as rf:
            for line in rf:
                if line.startswith("#"):
                    continue
                ele = GFF3Element.from_fields(line.strip().split("\t"))
                self.eles.append(ele)
                self.features.add(ele.feature)
                if ele.id is not None and (
                        ele.id.startswith("transcript")
                        or ele.id.startswith("gene")):
                    self.gt2idx[ele.id] = len(self.eles) - 1

        self.parent2exonidx: dict[str, list[int]] = {}
        for i, ele in enumerate(self.eles):
            if ele.feature == "exon" and ele.parent is not None:
                self.parent2exonidx.setdefault(ele.parent, []).append(i)

    def map_coordinates_transcript2genome(self, transcriptid: str):
        """-> (ensemblid, transcript_len, chrom, strand,
        per-base genome locations) (gff_reader.py:156-178)."""
        tele = self.eles[self.gt2idx[transcriptid]]
        exons = sorted((self.eles[i] for i in
                        self.parent2exonidx[transcriptid]),
                       key=lambda e: e.rank)
        strand = tele.strand
        locs: list[int] = []
        tlen = 0
        for exon in exons:
            genome_locs = list(range(exon.start, exon.end))
            if strand == "-":
                genome_locs.reverse()
            locs += genome_locs
            tlen += exon.end - exon.start
        return tele.ensemblid, tlen, tele.chromosome, strand, locs

    def save_coordinates_mapping(self, pkl_path: str) -> dict:
        mapping = {tid: self.map_coordinates_transcript2genome(tid)
                   for tid in self.parent2exonidx}
        print("mapped {} transcript coordinates..".format(len(mapping)))
        with open(pkl_path, "wb") as fh:
            pickle.dump(mapping, fh)
        return mapping

