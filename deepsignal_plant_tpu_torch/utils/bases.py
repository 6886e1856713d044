"""Base codes (copy of the parts of deepsignal_plant_tpu/utils/bases.py
that call_mods needs).

The integer codes are part of the on-disk feature format (the k-mer
column is encoded through them into the embedding vocabulary), so they
must match the reference tables in
deepsignal_plant/utils/process_utils.py:16-47 exactly.
"""
from __future__ import annotations

import numpy as np

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


def seq_to_codes(seq: str) -> np.ndarray:
    """Vectorized encode: str -> int32 array using the DNA alphabet."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENCODE_LUT_DNA[raw]
