"""Base codes and alphabets (copy of the parts of
deepsignal_plant_tpu/utils/bases.py that call_mods, call_freq and the
tools need).

The integer codes are part of the on-disk feature format (the k-mer
column is encoded through them into the embedding vocabulary), so they
must match the reference tables in
deepsignal_plant/utils/process_utils.py:16-47 exactly.
"""
from __future__ import annotations

import numpy as np

# Watson-Crick pairing plus IUPAC degenerate codes (DNA / RNA)
DNA_PAIRS = {
    "A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
    "W": "W", "S": "S", "M": "K", "K": "M", "R": "Y",
    "Y": "R", "B": "V", "V": "B", "D": "H", "H": "D",
    "Z": "Z",
}
RNA_PAIRS = {
    "A": "U", "C": "G", "G": "C", "U": "A", "N": "N",
    "W": "W", "S": "S", "M": "K", "K": "M", "R": "Y",
    "Y": "R", "B": "V", "V": "B", "D": "H", "H": "D",
    "Z": "Z",
}

# IUPAC degenerate letter -> concrete bases
IUPAC_DNA = {
    "A": ["A"], "T": ["T"], "C": ["C"], "G": ["G"],
    "R": ["A", "G"], "M": ["A", "C"], "S": ["C", "G"],
    "Y": ["C", "T"], "K": ["G", "T"], "W": ["A", "T"],
    "B": ["C", "G", "T"], "D": ["A", "G", "T"],
    "H": ["A", "C", "T"], "V": ["A", "C", "G"],
    "N": ["A", "C", "G", "T"],
}
IUPAC_RNA = {
    "A": ["A"], "C": ["C"], "G": ["G"], "U": ["U"],
    "R": ["A", "G"], "M": ["A", "C"], "S": ["C", "G"],
    "Y": ["C", "U"], "K": ["G", "U"], "W": ["A", "U"],
    "B": ["C", "G", "U"], "D": ["A", "G", "U"],
    "H": ["A", "C", "U"], "V": ["A", "C", "G"],
    "N": ["A", "C", "G", "U"],
}

# base -> integer code (the model's embedding vocabulary; vocab_size 16)
BASE2CODE_DNA = {
    "A": 0, "C": 1, "G": 2, "T": 3, "N": 4,
    "W": 5, "S": 6, "M": 7, "K": 8, "R": 9,
    "Y": 10, "B": 11, "V": 12, "D": 13, "H": 14,
    "Z": 15,
}
CODE2BASE_DNA = {v: k for k, v in BASE2CODE_DNA.items()}

# ASCII byte -> code, for numpy batch encoding; unknown letters are N
_ENCODE_LUT_DNA = np.full(256, BASE2CODE_DNA["N"], dtype=np.int32)
for _b, _c in BASE2CODE_DNA.items():
    _ENCODE_LUT_DNA[ord(_b)] = _c


def str2bool(v: str) -> bool:
    """Flag-string convention shared with the reference CLI
    (process_utils.py:54): yes/true/t/1 => True."""
    return str(v).lower() in ("yes", "true", "t", "1")


def complement_seq(seq: str, seq_type: str = "DNA") -> str:
    """Reverse-complement of ``seq``; unknown letters map to N
    (process_utils.py:65)."""
    if seq_type == "DNA":
        pairs = DNA_PAIRS
    elif seq_type == "RNA":
        pairs = RNA_PAIRS
    else:
        raise ValueError("seq_type must be DNA or RNA")
    return "".join(pairs.get(ch, "N") for ch in reversed(seq))


def seq_to_codes(seq: str) -> np.ndarray:
    """Vectorized encode: str -> int32 array using the DNA alphabet."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENCODE_LUT_DNA[raw]
