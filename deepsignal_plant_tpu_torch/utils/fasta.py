"""FASTA reference reading (copy of deepsignal_plant_tpu/utils/fasta.py,
without DNAContig, which nothing calls).

Parity targets: deepsignal_plant/utils/ref_reader.py:7-89 (DNAReference,
get_contig2len) and call_mods_freq.py:130-147 (contig-name
helpers). Sequences are upper-cased on load, contig names are the first
whitespace token after '>'.
"""
from __future__ import annotations


def iter_fasta(path: str):
    """Yield (name, seq) pairs from a FASTA file; seq upper-cased."""
    name = None
    chunks: list[str] = []
    with open(path) as rf:
        for line in rf:
            if line.startswith(">"):
                if name is not None and chunks:
                    yield name, "".join(chunks)
                name = line.strip()[1:].split(" ")[0]
                chunks = []
            else:
                chunks.append(line.strip().upper())
    if name is not None:
        yield name, "".join(chunks)


class DNAReference:
    """In-memory contig-name -> sequence map (ref_reader.py:33)."""

    def __init__(self, path: str):
        self._contignames: list[str] = []
        self._contigs: dict[str, str] = {}
        for name, seq in iter_fasta(path):
            self._contignames.append(name)
            self._contigs[name] = seq

    def getcontigs(self) -> dict[str, str]:
        return self._contigs

    def getcontignames(self) -> list[str]:
        return self._contignames


def get_contig2len(path: str) -> dict[str, int]:
    """contig name -> length (ref_reader.py:7)."""
    return {name: len(seq) for name, seq in iter_fasta(path)}


def get_contig_names(path: str) -> list[str]:
    """Contig names from a genome FASTA (call_mods_freq.py:130)."""
    names = []
    with open(path) as rf:
        for line in rf:
            if line.startswith(">"):
                names.append(line.strip()[1:].split(" ")[0])
    return names


def is_genome_fasta(path: str) -> bool:
    """Heuristic used by call_freq --contigs (call_mods_freq.py:140): first
    non-comment content line starting with '>' marks a FASTA."""
    with open(path) as rf:
        for line in rf:
            if line.startswith("#"):
                continue
            if line.startswith(">"):
                return True
    return False

