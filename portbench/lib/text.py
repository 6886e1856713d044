"""Text rows built in numpy: each field is a block of fixed-width byte
slots with a mask of the slots that print, so a whole block of rows is
one masked copy.

A part is a pair ``(chars, keep)`` of (n, w) uint8 and (n, w) bool
arrays, one row per output row; ``join`` concatenates the parts of each
row and keeps the masked slots.
"""
from __future__ import annotations

import numpy as np

ZERO = ord("0")


def const(n: int, text: bytes):
    """The same bytes in every row."""
    chars = np.broadcast_to(np.frombuffer(text, np.uint8), (n, len(text)))
    return chars, np.ones(chars.shape, bool)


def strings(values: np.ndarray):
    """Byte strings (a numpy ``S`` array) as a part, the padding
    masked."""
    n = len(values)
    w = values.dtype.itemsize
    chars = values.view(np.uint8).reshape(n, w)
    return chars, chars != 0


def uints(v: np.ndarray, width: int):
    """Non-negative integers in decimal, leading zeros masked; ``v`` of
    any shape gives parts of shape v.shape + (width,)."""
    v = np.asarray(v, np.int64)
    if v.size and (v.min() < 0 or v.max() >= 10 ** width):
        raise ValueError(f"integers outside [0, 1e{width})")
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    digits = (v[..., None] // pw) % 10
    keep = np.cumsum(digits, axis=-1) > 0
    keep[..., -1] = True
    return (digits + ZERO).astype(np.uint8), keep


def micro6(q: np.ndarray):
    """Micro-unit integers as ``%.6f`` text of q / 1e6 (one digit before
    the point); parts of shape q.shape + (9,)."""
    q = np.asarray(q)
    a = np.abs(q).astype(np.int32)
    if a.size and a.max() >= 10_000_000:
        raise ValueError("values of 10 or more units")
    chars = np.empty(q.shape + (9,), np.uint8)
    chars[..., 0] = ord("-")
    chars[..., 2] = ord(".")
    for slot in (8, 7, 6, 5, 4, 3, 1):
        a, d = np.divmod(a, 10)
        chars[..., slot] = d + ZERO
    keep = np.ones(chars.shape, bool)
    keep[..., 0] = q < 0
    return chars, keep


def separated(part, sep: bytes):
    """Tokens (n, k, w) joined by ``sep`` into (n, k * (w + 1)): each
    token's trailing separator slot is masked after the last token."""
    chars, keep = part
    n, k, w = chars.shape
    s = np.empty((n, k, w + 1), np.uint8)
    s[..., :w] = chars
    s[..., w] = ord(sep)
    m = np.empty((n, k, w + 1), bool)
    m[..., :w] = keep
    m[..., w] = True
    m[:, -1, w] = False
    return s.reshape(n, -1), m.reshape(n, -1)


def join(parts) -> tuple[bytes, np.ndarray]:
    """The rows' bytes, and each row's length."""
    chars = np.concatenate([np.asarray(c, np.uint8) for c, _ in parts],
                           axis=1)
    keep = np.concatenate([k for _, k in parts], axis=1)
    return chars[keep].tobytes(), keep.sum(axis=1)


def info_parts(chunk, sites: np.ndarray) -> list:
    """The six leading columns of the sites' rows (chrom, pos, strand,
    pos_in_strand, read name, read strand), without a trailing tab."""
    n = len(sites)
    tab = const(n, b"\t")
    return [strings(chunk.chrom[sites]), tab, uints(chunk.pos[sites], 10),
            tab, strings(chunk.strand[sites]), tab,
            uints(chunk.pos_in_strand[sites], 10), tab,
            strings(chunk.read_name[sites]), const(n, b"\tt")]
