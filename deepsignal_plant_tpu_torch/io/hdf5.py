"""A read-only reader, and a small writer, for the part of HDF5 that
fast5 files use: what h5py reads in single-read tombo fast5s, whether
MinKNOW, ont_fast5_api, tombo or h5py at ``libver="latest"`` wrote them.
Pure Python: numpy, struct and the standard library's zlib; VBZ through
io/vbz.py (the system's libzstd.so.1 by ctypes, the port's native
library). It imports no h5py.

Names below are those of the *HDF5 File Format Specification Version
3.0*.

Reader (``File``): opens a file by path, resolves objects by path
(``"Analyses/RawGenomeCorrected_000/BaseCalled_template/Events"``) and
returns attributes (numpy scalars or arrays; ``bytes`` for
variable-length strings) and datasets (numpy arrays; a structured dtype
for compound types). Links and attributes come in h5py's order:
creation order where the object tracks it, else name order. It reads

- superblock versions 0-3, with any size of offsets and lengths;
- object header versions 1 and 2 with continuation blocks (version 2
  checksums verified, Jenkins lookup3);
- old-style groups (symbol table message, v1 B-tree type 0, symbol
  nodes, local heap) and new-style groups with compact Link messages or
  dense link storage;
- attribute messages versions 1-3, compact or in dense attribute
  storage;
- dense storage: fractal heaps (managed objects in direct and indirect
  blocks, tiny objects, huge objects) and version 2 B-trees (record
  types 1, 5, 6, 8 and 9 for heaps and groups, 10 and 11 for chunks);
- fixed-point, IEEE float, fixed and variable-length strings (global
  heap collections), compound types (member encodings 1-3);
- scalar and simple dataspaces, with maximum dimensions;
- data layout version 3 (compact, contiguous, chunked with a v1 B-tree
  type 1) and version 4 (compact, contiguous, chunked with a single
  chunk, implicit, fixed-array (paged or not), extensible-array or v2
  B-tree index);
- filter pipeline versions 1 and 2: deflate, shuffle, fletcher32 and VBZ
  (filter 32020, version 0).

What it does not read raises ``UnsupportedFeature`` naming the feature:
shared object header messages, variable-length sequences, soft, external
and user-defined links, fractal heaps with I/O filters, other datatype
classes, and other filters; VBZ raises ``VBZPluginError`` when
libzstd.so.1 is missing or its version is not 0. Every address and
length is checked against the file's size, every walk is bounded and
every checksum of a version 2 structure is verified, so a corrupt file
raises ``HDF5FormatError`` (a ValueError) instead of hanging.

Writer (``write_file``): superblock 0, version 1 object headers,
symbol-table groups, contiguous datasets, chunked datasets (layout 3, a
v1 B-tree chunk index, a version 1 filter pipeline: deflate, shuffle,
fletcher32, or chunks encoded by the caller, as VBZ) and version 1
attributes -- the layout h5py writes by default for the tombo fixture.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
VBZ_FILTER_ID = 32020

#: bounds of every walk over file structures
MAX_BTREE_DEPTH = 32
MAX_NODES = 1 << 16
MAX_CONTINUATIONS = 1024
MAX_MESSAGES = 1 << 16        # header messages of one object
MAX_ENTRIES = 1 << 22         # B-tree entries of one walk
MAX_PATH_DEPTH = 64


class HDF5FormatError(ValueError):
    """The file is not HDF5 or its structures are corrupt."""


class UnsupportedFeature(HDF5FormatError):
    """The file uses a part of HDF5 this reader does not read."""

    def __init__(self, feature: str):
        super().__init__(f"unsupported HDF5 feature: {feature} (the "
                         "port's fast5 reader reads the subset of HDF5 "
                         "that single-read tombo fast5s use)")
        self.feature = feature


class VBZPluginError(UnsupportedFeature):
    """A VBZ-compressed dataset (HDF5 filter 32020) that this process
    cannot decode: the system's zstd library is missing, or the filter's
    version is not one the port decodes (io/vbz.py)."""

    def __init__(self, where: str = "", reason: str = ""):
        HDF5FormatError.__init__(
            self, f"{where}VBZ-compressed data (HDF5 filter "
            f"{VBZ_FILTER_ID}): {reason}. Or convert the fast5s without "
            "VBZ (ont_fast5_api compress_fast5 -c gzip), or read them with "
            "the JAX package deepsignal_plant_tpu and ONT's vbz plugin")
        self.feature = "VBZ filter 32020"


# ---------------------------------------------------------------------------
# Jenkins lookup3 (hashlittle), the checksum of version 2 structures
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    words = np.frombuffer(data[:n - n % 4], "<u4").tolist() if n >= 4 \
        else []
    off = 0
    w = 0
    while n - off > 12:
        a = (a + words[w]) & _M32
        b = (b + words[w + 1]) & _M32
        c = (c + words[w + 2]) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32
        off += 12
        w += 3
    rest = n - off
    if rest == 0:
        return c
    tail = data[off:] + b"\x00" * (12 - rest)
    ta, tb, tc = struct.unpack("<III", tail)
    a = (a + ta) & _M32
    b = (b + tb) & _M32
    c = (c + tc) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return c


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit
    words, sums folded every 360 words."""
    n = len(data)
    words = np.frombuffer(data[:n - n % 2], ">u2").astype(np.int64)
    sum1 = sum2 = 0
    for lo in range(0, len(words), 360):
        blk = words[lo:lo + 360]
        t = len(blk)
        sum2 = (sum2 + t * sum1
                + int((blk * np.arange(t, 0, -1)).sum())) & _M32
        sum1 = (sum1 + int(blk.sum())) & _M32
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if n % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return ((sum2 << 16) | sum1) & _M32


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _enc_size(n: int) -> int:
    """Bytes HDF5 gives a count of at most ``n`` (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise HDF5FormatError(f"{what} {n} is not a power of two")
    return n.bit_length() - 1


def _ordered(found: list, tracked: bool) -> dict:
    """{name: value} of (creation order, name, value) triples, in
    creation order when tracked, else in name (byte) order."""
    key = (lambda t: t[0]) if tracked else (lambda t: t[1].encode("utf-8"))
    return {name: value for _, name, value in sorted(found, key=key)}


class _Cursor:
    """Little-endian reads at a moving offset, bounded by ``end``."""
    __slots__ = ("buf", "pos", "end", "so", "sl")

    def __init__(self, f: "File", pos: int, end: int):
        if pos < 0 or end > len(f.buf) or pos > end:
            raise HDF5FormatError(f"structure at {pos} runs past the end "
                                  "of the file")
        self.buf, self.pos, self.end = f.buf, pos, end
        self.so, self.sl = f.so, f.sl

    @classmethod
    def over(cls, data: bytes, so: int, sl: int) -> "_Cursor":
        """A cursor over ``data`` itself (a message's embedded part)."""
        c = cls.__new__(cls)
        c.buf, c.pos, c.end, c.so, c.sl = data, 0, len(data), so, sl
        return c

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            raise HDF5FormatError(f"truncated structure at {self.pos}")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def u8(self) -> int:
        return self.uint(1)

    def u16(self) -> int:
        return self.uint(2)

    def u32(self) -> int:
        return self.uint(4)

    def addr(self) -> int:
        return self.uint(self.so)

    def length(self) -> int:
        return self.uint(self.sl)

    def skip(self, n: int) -> None:
        self.take(n)

    def align(self, base: int, to: int = 8) -> None:
        self.skip((-(self.pos - base)) % to)


class _Dtype:
    """A decoded datatype: the numpy dtype of its stored bytes, and
    whether elements are variable-length strings (global heap ids)."""
    __slots__ = ("np", "vlen_str")

    def __init__(self, npdt: np.dtype, vlen_str: bool = False):
        self.np = npdt
        self.vlen_str = vlen_str


class _Message:
    __slots__ = ("mtype", "pos", "size", "flags", "corder")

    def __init__(self, mtype, pos, size, flags, corder=0):
        self.mtype, self.pos, self.size, self.flags = mtype, pos, size, flags
        self.corder = corder


class File:
    """An HDF5 file read whole into memory. ``f[path]`` gives a Group or
    a Dataset; ``path in f`` tests for one."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            self.buf = fh.read()
        self._headers: dict[int, list] = {}
        self._links: dict[int, dict] = {}
        self._heaps: dict[int, dict] = {}
        self._fheaps: dict[int, _FractalHeap] = {}
        self._attr_order: dict[int, bool] = {}
        self._read_superblock()
        self.root = Group(self, self._root_addr, "/")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self.buf = b""

    # -- superblock -----------------------------------------------------
    def _read_superblock(self) -> None:
        buf = self.buf
        base = 0
        while True:
            if base + 8 > len(buf):
                raise HDF5FormatError("no HDF5 superblock signature")
            if buf[base:base + 8] == SIGNATURE:
                break
            base = 512 if base == 0 else base * 2
        self.base = base
        if base + 9 > len(buf):
            raise HDF5FormatError("truncated superblock")
        version = buf[base + 8]
        self.so = self.sl = 8
        if version in (0, 1):
            c = _Cursor(self, base + 9, len(buf))
            c.skip(4)                       # free-space, root, res, shared
            self.so, self.sl = c.u8(), c.u8()
            self._check_sizes()
            # reserved, group leaf and internal K, consistency flags, and
            # in version 1 the chunk B-tree K (walks read each node's
            # used entries, so the K values are not needed)
            c.skip(9 + (4 if version == 1 else 0))
            c.so, c.sl = self.so, self.sl
            c.addr()                        # base address (HDF5 re-bases
            c.addr()                        # to the signature's offset)
            c.addr()                        # end of file
            c.addr()                        # driver information block
            c.length()                      # root entry: link name offset
            self._root_addr = c.addr()
        elif version in (2, 3):
            c = _Cursor(self, base + 9, len(buf))
            self.so, self.sl = c.u8(), c.u8()
            self._check_sizes()
            c.so, c.sl = self.so, self.sl
            c.skip(1)
            c.addr()
            c.addr()                        # superblock extension
            c.addr()                        # end of file
            self._root_addr = c.addr()
            end = c.pos
            if c.u32() != lookup3(buf[base:end]):
                raise HDF5FormatError("superblock checksum mismatch")
        else:
            raise UnsupportedFeature(f"superblock version {version}")
        self.undef = (1 << (8 * self.so)) - 1

    def _check_sizes(self) -> None:
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise HDF5FormatError(f"sizes of offsets {self.so} and lengths "
                                  f"{self.sl}")

    def cursor(self, addr: int, n: int | None = None) -> _Cursor:
        """A cursor at relative address ``addr`` (``n`` bytes, or to the
        end of the file)."""
        if addr == self.undef:
            raise HDF5FormatError("undefined address")
        pos = self.base + addr
        return _Cursor(self, pos, len(self.buf) if n is None else pos + n)

    def read_at(self, addr: int, n: int) -> bytes:
        return self.cursor(addr, n).take(n)

    # -- object headers -------------------------------------------------
    def messages(self, addr: int) -> list[_Message]:
        if addr not in self._headers:
            self._headers[addr] = self._parse_header(addr)
        return self._headers[addr]

    def _parse_header(self, addr: int) -> list[_Message]:
        c = self.cursor(addr)
        if self.buf[c.pos:c.pos + 4] == b"OHDR":
            return self._parse_header_v2(c)
        version = c.u8()
        if version != 1:
            raise HDF5FormatError(f"object header version {version} at "
                                  f"{addr}")
        c.skip(1)
        nmsgs = c.u16()
        c.skip(4)                           # reference count
        size = c.u32()
        c.skip(4)                           # alignment of version 1
        blocks = [(c.pos, c.pos + size)]
        msgs: list[_Message] = []
        seen = {addr}
        while blocks:
            lo, hi = blocks.pop(0)
            b = _Cursor(self, lo, hi)
            while b.end - b.pos >= 8 and len(msgs) < nmsgs:
                mtype, msize, flags = b.u16(), b.u16(), b.u8()
                b.skip(3)
                pos = b.pos
                b.skip(msize)
                msgs.append(_Message(mtype, pos, msize, flags))
                if mtype == 0x10:
                    blocks.append(self._continuation(pos, seen, 1))
        return msgs

    def _continuation(self, pos: int, seen: set, version: int):
        c = _Cursor(self, pos, len(self.buf))
        caddr, clen = c.addr(), c.length()
        if caddr in seen or len(seen) > MAX_CONTINUATIONS:
            raise HDF5FormatError("object header continuation loop")
        seen.add(caddr)
        lo = self.cursor(caddr, clen).pos
        if version == 1:
            return lo, lo + clen
        if self.buf[lo:lo + 4] != b"OCHK" or clen < 8:
            raise HDF5FormatError("bad OCHK continuation block")
        if struct.unpack_from("<I", self.buf, lo + clen - 4)[0] != \
                lookup3(self.buf[lo:lo + clen - 4]):
            raise HDF5FormatError("continuation block checksum mismatch")
        return lo + 4, lo + clen - 4

    def _parse_header_v2(self, c: _Cursor) -> list[_Message]:
        start = c.pos
        c.skip(4)
        if c.u8() != 2:
            raise HDF5FormatError("OHDR version")
        flags = c.u8()
        if flags & 0x20:
            c.skip(16)                      # access/modification/... times
        if flags & 0x10:
            c.skip(4)                       # attribute phase change values
        size = c.uint(1 << (flags & 3))
        lo = c.pos
        c.skip(size)
        stored = c.u32()
        if stored != lookup3(self.buf[start:lo + size]):
            raise HDF5FormatError("object header checksum mismatch")
        order = bool(flags & 0x04)
        self._attr_order[start - self.base] = order
        blocks = [(lo, lo + size)]
        msgs: list[_Message] = []
        seen = {start - self.base}
        while blocks:
            blo, bhi = blocks.pop(0)
            b = _Cursor(self, blo, bhi)
            hdr = 6 if order else 4
            while b.end - b.pos >= hdr:
                mtype, msize, mflags = b.u8(), b.u16(), b.u8()
                corder = b.u16() if order else 0
                pos = b.pos
                b.skip(msize)
                msgs.append(_Message(mtype, pos, msize, mflags, corder))
                if len(msgs) > MAX_MESSAGES:
                    raise HDF5FormatError("too many header messages")
                if mtype == 0x10:
                    blocks.append(self._continuation(pos, seen, 2))
        return msgs

    def _msg(self, m: _Message) -> _Cursor:
        if m.flags & 0x02:
            raise UnsupportedFeature("shared object header messages")
        return _Cursor(self, m.pos, m.pos + m.size)

    # -- groups ---------------------------------------------------------
    def links(self, addr: int) -> dict[str, int]:
        """name -> object header address of a group's hard links, in the
        order h5py lists them: creation order where the group tracks it,
        else name order (bytes)."""
        if addr not in self._links:
            self._links[addr] = self._read_links(addr)
        return self._links[addr]

    def _read_links(self, addr: int) -> dict[str, int]:
        msgs = self.messages(addr)
        for m in msgs:
            if m.mtype == 0x11:
                c = self._msg(m)
                btree, heap = c.addr(), c.addr()
                return _ordered([(0, n, a) for n, a in self._symbol_table(
                    btree, heap).items()], False)
        found: list[tuple[int, str, int]] = []
        tracked = False
        for m in msgs:
            if m.mtype == 0x02:
                c = self._msg(m)
                if c.u8() != 0:
                    raise HDF5FormatError("link info message version")
                fl = c.u8()
                tracked = bool(fl & 1)
                if fl & 1:
                    c.skip(8)
                heap, name_bt = c.addr(), c.addr()
                order_bt = c.addr() if fl & 2 else self.undef
                if heap != self.undef:
                    found += self._dense_links(heap, name_bt, order_bt,
                                               tracked)
            elif m.mtype == 0x06:
                found.append(self._link(self._msg(m)))
        return _ordered(found, tracked)

    def _dense_links(self, heap: int, name_bt: int, order_bt: int,
                     tracked: bool) -> list:
        """Links held in a fractal heap, indexed by a v2 B-tree of name
        hashes (record type 5) or, where kept, of creation order (6)."""
        fh = self.fractal_heap(heap)
        if tracked and order_bt != self.undef:
            ids = [r[8:15] for r in self.btree2(order_bt, 6)]
        elif name_bt != self.undef:
            ids = [r[4:11] for r in self.btree2(name_bt, 5)]
        else:
            raise HDF5FormatError("dense links without a name index")
        return [self._link(_Cursor.over(fh.object(i), self.so, self.sl))
                for i in ids]

    def _link(self, c: _Cursor) -> tuple[int, str, int]:
        """(creation order, name, target) of a Link message."""
        if c.u8() != 1:
            raise HDF5FormatError("link message version")
        flags = c.u8()
        ltype = c.u8() if flags & 0x08 else 0
        corder = c.uint(8) if flags & 0x04 else 0
        if flags & 0x10:
            c.skip(1)
        name = c.take(c.uint(1 << (flags & 3))).decode("utf-8", "replace")
        if ltype == 0:
            return corder, name, c.addr()
        if ltype == 1:
            raise UnsupportedFeature(f"soft link {name!r}")
        raise UnsupportedFeature(f"external or user-defined link {name!r}")

    def _local_heap(self, addr: int) -> tuple[int, int]:
        """(position, size) of a local heap's data segment."""
        c = self.cursor(addr)
        if c.take(4) != b"HEAP":
            raise HDF5FormatError(f"no local heap at {addr}")
        c.skip(4)
        size = c.length()
        c.length()                          # free list head
        data = c.addr()
        return self.cursor(data, size).pos, size

    def _heap_name(self, heap: tuple[int, int], off: int) -> str:
        lo, size = heap
        if off >= size:
            raise HDF5FormatError("name offset outside the local heap")
        end = self.buf.find(b"\x00", lo + off, lo + size)
        if end < 0:
            raise HDF5FormatError("unterminated name in the local heap")
        return self.buf[lo + off:end].decode("utf-8", "replace")

    def _btree_leaves(self, addr: int, node_type: int, key_size: int):
        """(key bytes, child address) of every level-0 entry of a v1
        B-tree, left to right; depth, node count and revisits bounded."""
        out = []
        seen: set[int] = set()

        def walk(a: int, depth: int, want_level: int | None):
            if a in seen or len(seen) >= MAX_NODES:
                raise HDF5FormatError("B-tree loop or too many nodes")
            if depth > MAX_BTREE_DEPTH:
                raise HDF5FormatError("B-tree too deep")
            seen.add(a)
            c = self.cursor(a)
            if c.take(4) != b"TREE":
                raise HDF5FormatError(f"no B-tree node at {a}")
            if c.u8() != node_type:
                raise HDF5FormatError("B-tree node type")
            level, used = c.u8(), c.u16()
            if want_level is not None and level != want_level:
                raise HDF5FormatError("B-tree levels inconsistent")
            c.addr()
            c.addr()
            entries = []
            for _ in range(used):
                key = c.take(key_size)
                entries.append((key, c.addr()))
            if len(out) + len(entries) > MAX_ENTRIES:
                raise HDF5FormatError("B-tree has too many entries")
            for key, child in entries:
                if level == 0:
                    out.append((key, child))
                else:
                    walk(child, depth + 1, level - 1)

        walk(addr, 0, None)
        return out

    def _symbol_table(self, btree: int, heap_addr: int) -> dict[str, int]:
        heap = self._local_heap(heap_addr)
        out: dict[str, int] = {}
        for _key, snod in self._btree_leaves(btree, 0, self.sl):
            c = self.cursor(snod)
            if c.take(4) != b"SNOD":
                raise HDF5FormatError(f"no symbol node at {snod}")
            c.skip(2)
            for _ in range(c.u16()):
                name_off, obj = c.length(), c.addr()
                c.skip(24)                  # cache type, reserved, scratch
                out[self._heap_name(heap, name_off)] = obj
        return out

    # -- v2 B-trees and fractal heaps ----------------------------------
    def btree2(self, addr: int, want_type: int) -> list[bytes]:
        """The records of a version 2 B-tree of type ``want_type``, in
        order, as raw bytes; node count, depth and entries bounded, every
        checksum verified."""
        c = self.cursor(addr)
        start = c.pos
        if c.take(4) != b"BTHD" or c.u8() != 0:
            raise HDF5FormatError(f"no v2 B-tree header at {addr}")
        btype = c.u8()
        if btype != want_type:
            raise HDF5FormatError(f"v2 B-tree of type {btype}, expected "
                                  f"{want_type}")
        node_size, rsize, depth = c.u32(), c.u16(), c.u16()
        c.skip(2)                           # split and merge percents
        root, nroot, total = c.addr(), c.u16(), c.length()
        if c.u32() != lookup3(self.buf[start:c.pos - 4]):
            raise HDF5FormatError("v2 B-tree header checksum mismatch")
        if rsize == 0 or node_size < 10 + rsize or node_size > 1 << 24 or \
                depth > MAX_BTREE_DEPTH or total > MAX_ENTRIES:
            raise HDF5FormatError(f"v2 B-tree header: node size "
                                  f"{node_size}, record size {rsize}, "
                                  f"depth {depth}, {total} records")
        # H5B2__hdr_init: the most records of a node at each depth, the
        # bytes of a child's record count, and of its subtree's total
        max_rec = [(node_size - 10) // rsize]
        nrec_size = _enc_size(max_rec[0])
        cum, cum_size = [max_rec[0]], [0]
        for d in range(1, depth + 1):
            ptr = self.so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            max_rec.append((node_size - (10 + ptr)) // (rsize + ptr))
            if max_rec[d] < 1:
                raise HDF5FormatError("v2 B-tree nodes too small")
            cum.append((max_rec[d] + 1) * cum[d - 1] + max_rec[d])
            cum_size.append(_enc_size(cum[d]))
        out: list[bytes] = []
        seen: set[int] = set()

        def walk(a: int, d: int, n: int) -> None:
            if a == self.undef or a in seen or len(seen) >= MAX_NODES:
                raise HDF5FormatError("v2 B-tree loop or bad node address")
            if n > max_rec[d] or len(out) + n > MAX_ENTRIES:
                raise HDF5FormatError(f"v2 B-tree node of {n} records")
            seen.add(a)
            c = self.cursor(a)
            lo = c.pos
            if c.take(4) != (b"BTIN" if d else b"BTLF") or c.u8() != 0 \
                    or c.u8() != btype:
                raise HDF5FormatError(f"bad v2 B-tree node at {a}")
            recs = [c.take(rsize) for _ in range(n)]
            kids = []
            if d:
                for _ in range(n + 1):
                    kid, kn = c.addr(), c.uint(nrec_size)
                    if d > 1:
                        c.uint(cum_size[d - 1])
                    kids.append((kid, kn))
            if c.u32() != lookup3(self.buf[lo:c.pos - 4]):
                raise HDF5FormatError("v2 B-tree node checksum mismatch")
            for i, rec in enumerate(recs):
                if d:
                    walk(kids[i][0], d - 1, kids[i][1])
                out.append(rec)
            if d:
                walk(kids[n][0], d - 1, kids[n][1])

        if nroot:
            walk(root, depth, nroot)
        if len(out) != total:
            raise HDF5FormatError(f"v2 B-tree holds {len(out)} records, "
                                  f"its header says {total}")
        return out

    def fractal_heap(self, addr: int) -> "_FractalHeap":
        if addr not in self._fheaps:
            self._fheaps[addr] = _FractalHeap(self, addr)
        return self._fheaps[addr]

    # -- datatypes, dataspaces ------------------------------------------
    def datatype(self, c: _Cursor) -> _Dtype:
        cv = c.u8()
        cls, version = cv & 0x0F, cv >> 4
        bits = c.uint(3)
        size = c.u32()
        if size == 0 or size > (1 << 20):
            raise HDF5FormatError(f"datatype size {size}")
        if cls == 0:                        # fixed-point
            off, prec = c.u16(), c.u16()
            if off != 0 or prec != 8 * size or size not in (1, 2, 4, 8):
                raise UnsupportedFeature(f"{prec}-bit integer at bit {off}"
                                         f" in {size} bytes")
            order = ">" if bits & 1 else "<"
            kind = "i" if bits & 0x08 else "u"
            return _Dtype(np.dtype(f"{order}{kind}{size}"))
        if cls == 1:                        # floating point
            props = c.take(12)
            off, prec, eloc, esize, mloc, msize, bias = struct.unpack(
                "<HHBBBBI", props)
            ieee = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127),
                    8: (52, 11, 0, 52, 1023)}
            if bits & 0x40 or off != 0 or prec != 8 * size or \
                    ieee.get(size) != (eloc, esize, mloc, msize, bias):
                raise UnsupportedFeature(f"non-IEEE {size}-byte float")
            order = ">" if bits & 1 else "<"
            return _Dtype(np.dtype(f"{order}f{size}"))
        if cls == 3:                        # fixed-length string
            return _Dtype(np.dtype(f"S{size}"))
        if cls == 6:                        # compound
            return self._compound(c, version, bits & 0xFFFF, size)
        if cls == 9:                        # variable length
            if bits & 0x0F != 1:
                raise UnsupportedFeature("variable-length sequences")
            self.datatype(c)                # base type
            return _Dtype(np.dtype(f"V{size}"), vlen_str=True)
        names = {2: "time", 4: "bitfield", 5: "opaque", 7: "reference",
                 8: "enumeration", 10: "array"}
        raise UnsupportedFeature(f"{names.get(cls, f'class {cls}')} "
                                 "datatype")

    def _compound(self, c: _Cursor, version: int, nmembers: int,
                  size: int) -> _Dtype:
        names, formats, offsets = [], [], []
        off_bytes = 1 if size < 1 << 8 else 2 if size < 1 << 16 else \
            3 if size < 1 << 24 else 4
        for _ in range(nmembers):
            start = c.pos
            end = c.buf.find(b"\x00", start, c.end)
            if end < 0:
                raise HDF5FormatError("unterminated compound member name")
            name = c.take(end - start + 1)[:-1].decode("utf-8", "replace")
            if version in (1, 2):
                c.align(start)
                off = c.u32()
            elif version in (3, 4):         # 4 encodes members as 3
                off = c.uint(off_bytes)
            else:
                raise HDF5FormatError(f"compound datatype version "
                                      f"{version}")
            if version == 1:
                ndims = c.u8()
                c.skip(3 + 4 + 4 + 16)
                if ndims:
                    raise UnsupportedFeature("array members of compounds")
            mt = self.datatype(c)
            if mt.vlen_str or mt.np.fields is not None:
                raise UnsupportedFeature("nested or variable-length "
                                         "compound members")
            if off + mt.np.itemsize > size:
                raise HDF5FormatError("compound member past its type")
            names.append(name)
            formats.append(mt.np)
            offsets.append(off)
        try:
            dt = np.dtype({"names": names, "formats": formats,
                           "offsets": offsets, "itemsize": size})
        except (ValueError, TypeError) as exc:
            raise HDF5FormatError(f"compound datatype: {exc}") from None
        return _Dtype(dt)

    def dataspace(self, c: _Cursor, with_max: bool = False):
        """The shape: ``()`` for a scalar, None for a null dataspace; with
        ``with_max`` (shape, maximum shape), None for an unlimited
        dimension, the shape where no maximum is stored."""
        version = c.u8()
        rank = c.u8()
        flags = c.u8()
        if version == 1:
            c.skip(5)
            kind = 1 if rank else 0
        elif version == 2:
            kind = c.u8()
        else:
            raise HDF5FormatError(f"dataspace version {version}")
        if rank > 32:
            raise HDF5FormatError(f"dataspace rank {rank}")
        if kind == 2:
            return (None, None) if with_max else None
        dims = tuple(c.length() for _ in range(rank))
        shape = dims if kind == 1 else ()
        if not with_max:
            return shape
        if not flags & 1 or kind != 1:
            return shape, shape
        undef = (1 << (8 * self.sl)) - 1
        return shape, tuple(None if m == undef else m for m in
                            (c.length() for _ in range(rank)))

    # -- global heap ----------------------------------------------------
    def vlen_strings(self, raw: bytes, n: int) -> list[bytes]:
        """Variable-length strings from ``n`` stored (length, heap id)
        elements."""
        out = []
        step = 4 + self.so + 4
        for i in range(n):
            e = raw[i * step:(i + 1) * step]
            length = int.from_bytes(e[:4], "little")
            coll = int.from_bytes(e[4:4 + self.so], "little")
            index = int.from_bytes(e[4 + self.so:], "little")
            if length == 0 and coll == 0:
                out.append(b"")
                continue
            obj = self._global_heap(coll).get(index)
            if obj is None:
                raise HDF5FormatError(f"global heap object {index} "
                                      "missing")
            out.append(obj[:length])
        return out

    def _global_heap(self, addr: int) -> dict[int, bytes]:
        if addr in self._heaps:
            return self._heaps[addr]
        c = self.cursor(addr)
        if c.take(4) != b"GCOL":
            raise HDF5FormatError(f"no global heap collection at {addr}")
        c.skip(4)
        size = c.length()
        c = _Cursor(self, c.pos, min(len(self.buf),
                                     self.base + addr + size))
        objs: dict[int, bytes] = {}
        while c.end - c.pos >= 8 + self.sl:
            index = c.u16()
            c.skip(6)
            osize = c.length()
            if index == 0:
                break
            start = c.pos
            objs[index] = c.take(osize)
            c.align(start)
        self._heaps[addr] = objs
        return objs

    # -- values ---------------------------------------------------------
    def to_value(self, dt: _Dtype, shape, raw: bytes):
        n = math.prod(shape)
        if dt.vlen_str:
            vals = self.vlen_strings(raw, n)
            if shape == ():
                return vals[0]
            arr = np.empty(n, object)
            arr[:] = vals
            return arr.reshape(shape)
        arr = np.frombuffer(raw, dt.np, count=n)
        return arr.reshape(shape)[()] if shape == () else \
            arr.reshape(shape).copy()

    def attributes(self, addr: int) -> dict:
        """name -> value of an object's attributes, in the order h5py
        lists them: creation order where the object tracks it, else name
        order (bytes)."""
        found: list[tuple[int, str, object]] = []
        msgs = self.messages(addr)
        tracked = self._attr_order.get(addr, False)
        for m in msgs:
            if m.mtype == 0x15:
                c = self._msg(m)
                if c.u8() != 0:
                    raise HDF5FormatError("attribute info version")
                fl = c.u8()
                tracked = tracked or bool(fl & 1)
                if fl & 1:
                    c.skip(2)
                heap, name_bt = c.addr(), c.addr()
                order_bt = c.addr() if fl & 2 else self.undef
                if heap != self.undef:
                    found += self._dense_attributes(heap, name_bt, order_bt,
                                                    tracked)
            elif m.mtype == 0x0C:
                name, value = self._attribute(self._msg(m))
                found.append((m.corder, name, value))
        return _ordered(found, tracked)

    def _dense_attributes(self, heap: int, name_bt: int, order_bt: int,
                          tracked: bool) -> list:
        """Attributes held in a fractal heap, indexed by a v2 B-tree of
        name hashes (record type 8) or, where kept, of creation order
        (9)."""
        fh = self.fractal_heap(heap)
        if tracked and order_bt != self.undef:
            recs = self.btree2(order_bt, 9)
        elif name_bt != self.undef:
            recs = self.btree2(name_bt, 8)
        else:
            raise HDF5FormatError("dense attributes without a name index")
        out = []
        for r in recs:
            if r[8] & 0x02:
                raise UnsupportedFeature("shared object header messages")
            name, value = self._attribute(
                _Cursor.over(fh.object(r[:8]), self.so, self.sl))
            out.append((int.from_bytes(r[9:13], "little"), name, value))
        return out

    def _attribute(self, c: _Cursor):
        version = c.u8()
        flags = c.u8()
        if version not in (1, 2, 3):
            raise HDF5FormatError(f"attribute message version {version}")
        if version > 1 and flags & 0x03:
            raise UnsupportedFeature("shared attribute datatype or "
                                     "dataspace")
        nsize, tsize, ssize = c.u16(), c.u16(), c.u16()
        if version == 3:
            c.skip(1)

        def part(n):
            p = c.take(n)
            if version == 1:
                c.skip(-n % 8)
            return p
        name = part(nsize).split(b"\x00", 1)[0].decode("utf-8", "replace")
        tpart, spart = part(tsize), part(ssize)
        dt = self.datatype(_Cursor.over(tpart, self.so, self.sl))
        shape = self.dataspace(_Cursor.over(spart, self.so, self.sl))
        if shape is None:
            return name, None
        n = math.prod(shape)
        raw = c.take(n * dt.np.itemsize)
        return name, self.to_value(dt, shape, raw)

    # -- paths ----------------------------------------------------------
    def resolve(self, path: str) -> int:
        addr = self._root_addr
        parts = [p for p in path.split("/") if p]
        if len(parts) > MAX_PATH_DEPTH:
            raise HDF5FormatError("path too deep")
        for p in parts:
            links = self.links(addr)
            if p not in links:
                raise KeyError(path)
            addr = links[p]
        return addr

    def __getitem__(self, path: str):
        return self.root[path]

    def __contains__(self, path: str) -> bool:
        return path in self.root

    def keys(self) -> list[str]:
        return self.root.keys()


class _FractalHeap:
    """A fractal heap (``FRHP``): managed objects in direct blocks under
    a doubling table of indirect blocks, tiny objects inside their heap
    ids, huge objects in blocks of their own found through a v2 B-tree
    (record type 1) or from the id itself. Heaps with I/O filters are
    refused by name."""

    def __init__(self, f: File, addr: int):
        self.f, self.addr = f, addr
        c = f.cursor(addr)
        start = c.pos
        if c.take(4) != b"FRHP" or c.u8() != 0:
            raise HDF5FormatError(f"no fractal heap header at {addr}")
        self.id_len, filter_len, flags = c.u16(), c.u16(), c.u8()
        max_man = c.u32()
        c.length()                          # next huge object id
        self.huge_bt = c.addr()
        c.length()                          # free space in managed blocks
        c.addr()                            # free-space manager
        c.length()                          # managed space
        c.length()                          # allocated managed space
        c.length()                          # direct block iterator offset
        c.length()                          # managed objects
        c.skip(4 * f.sl)                    # huge and tiny sizes, counts
        self.width, self.start_block = c.u16(), c.length()
        self.max_dblock, heap_bits = c.length(), c.u16()
        c.u16()                             # starting rows of the root
        self.root, self.root_rows = c.addr(), c.u16()
        if filter_len:
            raise UnsupportedFeature("filtered fractal heap (dense link or "
                                     "attribute storage with I/O filters)")
        if c.u32() != lookup3(f.buf[start:c.pos - 4]):
            raise HDF5FormatError("fractal heap header checksum mismatch")
        self.dblock_checksums = bool(flags & 2)
        if not 1 <= self.width <= 1 << 16 or not 1 <= heap_bits <= 64 or \
                self.id_len < 2 or self.root_rows > 64:
            raise HDF5FormatError("fractal heap header")
        sb = _log2(self.start_block, "fractal heap starting block size")
        mb = _log2(self.max_dblock, "fractal heap largest direct block")
        self.first_row_bits = sb + _log2(self.width, "fractal heap width")
        if mb < sb or mb > 40:
            raise HDF5FormatError("fractal heap block sizes")
        self.max_direct_rows = mb - sb + 2
        self.off_size = (heap_bits + 7) // 8
        self.len_size = min((mb + 7) // 8, _enc_size(max_man))
        self._blocks: list | None = None
        self._checked: set[int] = set()
        self._huge: dict | None = None

    def _row_size(self, r: int) -> int:
        return self.start_block << max(r - 1, 0)

    def blocks(self) -> list[tuple[int, int, int]]:
        """(heap offset, file address, size) of every direct block."""
        if self._blocks is None:
            out: list = []
            if self.root != self.f.undef:
                if self.root_rows == 0:
                    out.append((0, self.root, self.start_block))
                else:
                    self._indirect(self.root, self.root_rows, 0, out, 0)
            self._blocks = sorted(out)
        return self._blocks

    def _block_offset(self, c: _Cursor, sig: bytes, at: int, off: int):
        if c.take(4) != sig or c.u8() != 0 or c.addr() != self.addr or \
                c.uint(self.off_size) != off:
            raise HDF5FormatError(f"bad fractal heap block at {at}")

    def _indirect(self, addr: int, nrows: int, off: int, out: list,
                  depth: int) -> None:
        f = self.f
        if depth > MAX_BTREE_DEPTH or len(out) > MAX_NODES:
            raise HDF5FormatError("fractal heap too deep or too large")
        c = f.cursor(addr)
        start = c.pos
        self._block_offset(c, b"FHIB", addr, off)
        kids = [c.addr() for _ in range(nrows * self.width)]
        if c.u32() != lookup3(f.buf[start:c.pos - 4]):
            raise HDF5FormatError("fractal heap indirect block checksum "
                                  "mismatch")
        for i, kid in enumerate(kids):
            r = i // self.width
            size = self._row_size(r)
            if kid != f.undef:
                if r < self.max_direct_rows:
                    out.append((off, kid, size))
                else:
                    rows = size.bit_length() - 1 - self.first_row_bits + 1
                    self._indirect(kid, rows, off, out, depth + 1)
            off += size

    def _managed(self, off: int, length: int) -> bytes:
        blocks = self.blocks()
        lo, hi = 0, len(blocks)
        while lo < hi:
            mid = (lo + hi) // 2
            if blocks[mid][0] <= off:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0:
            raise HDF5FormatError(f"fractal heap offset {off} in no block")
        boff, baddr, bsize = blocks[lo - 1]
        if off + length > boff + bsize:
            raise HDF5FormatError(f"fractal heap object at {off} of "
                                  f"{length} bytes runs past its block")
        f = self.f
        c = f.cursor(baddr, bsize)
        if baddr not in self._checked:
            start = c.pos
            self._block_offset(c, b"FHDB", baddr, boff)
            if self.dblock_checksums:
                at = c.pos
                stored = c.u32()
                block = bytearray(c.buf[start:start + bsize])
                block[at - start:at - start + 4] = bytes(4)
                if stored != lookup3(bytes(block)):
                    raise HDF5FormatError("fractal heap direct block "
                                          "checksum mismatch")
            if off - boff < c.pos - start:
                raise HDF5FormatError(f"fractal heap object at {off} "
                                      "inside a block header")
            self._checked.add(baddr)
        return f.read_at(baddr + off - boff, length)

    def _huge_object(self, hid: bytes) -> bytes:
        f = self.f
        if self.id_len - 1 >= f.so + f.sl:  # address and length in the id
            c = _Cursor.over(hid[1:], f.so, f.sl)
            return f.read_at(c.addr(), c.length())
        if self._huge is None:
            self._huge = {}
            if self.huge_bt != f.undef:
                for r in f.btree2(self.huge_bt, 1):
                    c = _Cursor.over(r, f.so, f.sl)
                    a, n = c.addr(), c.length()
                    self._huge[c.length()] = (a, n)
        key = int.from_bytes(hid[1:1 + min(self.id_len - 1, 8)], "little")
        if key not in self._huge:
            raise HDF5FormatError(f"huge fractal heap object {key} missing")
        return f.read_at(*self._huge[key])

    def object(self, hid: bytes) -> bytes:
        """The bytes of the object with heap id ``hid``."""
        if len(hid) < min(self.id_len, 2) or hid[0] & 0xC0:
            raise HDF5FormatError("bad fractal heap id")
        kind = hid[0] & 0x30
        if kind == 0x00:
            c = _Cursor.over(hid[1:], self.f.so, self.f.sl)
            off, length = c.uint(self.off_size), c.uint(self.len_size)
            return self._managed(off, length)
        if kind == 0x10:
            return self._huge_object(hid)
        if kind == 0x20:
            if self.id_len - 1 > 16:        # extended tiny length
                n = (((hid[0] & 0x0F) << 8) | hid[1]) + 1
                data = hid[2:2 + n]
            else:
                n = (hid[0] & 0x0F) + 1
                data = hid[1:1 + n]
            if len(data) != n:
                raise HDF5FormatError("tiny fractal heap object too long")
            return bytes(data)
        raise HDF5FormatError("fractal heap id of unknown type")


class _Object:
    def __init__(self, f: File, addr: int, name: str):
        self.file, self.addr, self.name = f, addr, name

    @property
    def attrs(self) -> dict:
        return self.file.attributes(self.addr)


class Group(_Object):
    def keys(self) -> list[str]:
        """Link names in h5py's order: creation order where the group
        tracks it, else byte order (HDF5's name index order)."""
        return list(self.file.links(self.addr))

    def _child(self, path: str):
        full = self.name.rstrip("/") + "/" + path.strip("/")
        addr = self.file.resolve(full)
        kinds = {m.mtype for m in self.file.messages(addr)}
        if 0x08 in kinds:
            return Dataset(self.file, addr, full)
        return Group(self.file, addr, full)

    def __getitem__(self, path: str):
        return self._child(path)

    def __contains__(self, path: str) -> bool:
        try:
            self.file.resolve(self.name.rstrip("/") + "/" + path.strip("/"))
        except KeyError:
            return False
        return True


class Dataset(_Object):
    def _meta(self):
        f = self.file
        dt = shape = layout = None
        filters: list = []
        for m in f.messages(self.addr):
            if m.mtype == 0x03:
                dt = f.datatype(f._msg(m))
            elif m.mtype == 0x01:
                shape, maxshape = f.dataspace(f._msg(m), with_max=True)
            elif m.mtype == 0x08:
                layout = m
            elif m.mtype == 0x0B:
                filters = _filter_pipeline(f._msg(m))
        if dt is None or layout is None:
            raise HDF5FormatError(f"{self.name}: no datatype or layout")
        if shape is None:
            raise UnsupportedFeature("null dataspace dataset")
        if any(m is not None and m < n for n, m in zip(shape, maxshape)):
            raise HDF5FormatError(f"{self.name}: shape {shape} beyond its "
                                  f"maximum {maxshape}")
        return dt, (shape, maxshape), layout, filters

    def read(self) -> np.ndarray:
        f = self.file
        dt, (shape, maxshape), layout, filters = self._meta()
        n = math.prod(shape)
        nbytes = n * dt.np.itemsize
        # deflate expands at most ~1032:1; nothing this file holds can
        # decode to more
        if nbytes > 1100 * len(f.buf) + (1 << 20):
            raise HDF5FormatError(f"{self.name}: {nbytes} bytes of data "
                                  f"in a file of {len(f.buf)}")
        raw = _read_layout(f, f._msg(layout), dt.np, shape, maxshape,
                           nbytes, filters, self.name)
        return f.to_value(dt, shape, raw) if shape == () or dt.vlen_str \
            else np.frombuffer(raw, dt.np, count=n).reshape(shape)

    def __getitem__(self, key):
        return self.read()[key]


def _filter_pipeline(c: _Cursor) -> list[tuple[int, str, list[int]]]:
    version, n = c.u8(), c.u8()
    if version == 1:
        c.skip(6)
    elif version != 2:
        raise HDF5FormatError(f"filter pipeline version {version}")
    out = []
    for _ in range(n):
        fid = c.u16()
        nlen = c.u16() if version == 1 or fid >= 256 else 0
        c.u16()                             # flags
        nvals = c.u16()
        name = c.take(nlen).split(b"\x00", 1)[0].decode("ascii", "replace")
        vals = [c.u32() for _ in range(nvals)]
        if version == 1 and nvals % 2:
            c.skip(4)
        out.append((fid, name, vals))
    return out


def _unfilter(data: bytes, filters, mask: int, expect: int, where: str
              ) -> bytes:
    for i in range(len(filters) - 1, -1, -1):
        if mask & (1 << i):
            continue
        fid, name, vals = filters[i]
        if fid == 1:
            d = zlib.decompressobj()
            try:
                out = d.decompress(data, expect + 1)
            except zlib.error as exc:
                raise HDF5FormatError(f"{where}: deflate: {exc}") from None
            data = out
        elif fid == 2:
            size = vals[0] if vals else 1
            if size > 1:
                m = len(data) // size
                body = np.frombuffer(data[:m * size], np.uint8)
                data = body.reshape(size, m).T.tobytes() + data[m * size:]
        elif fid == 3:
            if len(data) < 4:
                raise HDF5FormatError(f"{where}: fletcher32 chunk too short")
            stored = struct.unpack("<I", data[-4:])[0]
            body = data[:-4]
            if stored != fletcher32(body):
                raise HDF5FormatError(f"{where}: fletcher32 mismatch")
            data = body
        elif fid == VBZ_FILTER_ID:
            from . import vbz
            data = vbz.decode_chunk(data, vals, expect if i == 0 else None,
                                    f"{where}: ")
        else:
            raise UnsupportedFeature(f"filter {fid} ({name or 'unnamed'})")
    return data


def _place(out: np.ndarray, chunk: bytes, dt: np.dtype, cdims, offs,
           where: str) -> None:
    """Copy one decoded chunk into ``out`` at element offsets ``offs``,
    clipped to the dataset's extent."""
    need = math.prod(cdims) * dt.itemsize
    if len(chunk) < need:
        raise HDF5FormatError(f"{where}: chunk of {len(chunk)} bytes, "
                              f"expected {need}")
    if any(o < 0 or o >= s or o % c for o, s, c in zip(offs, out.shape,
                                                        cdims)):
        raise HDF5FormatError(f"{where}: chunk offset {offs}")
    arr = np.frombuffer(chunk, dt, count=math.prod(cdims)).reshape(cdims)
    sl_out = tuple(slice(o, min(o + c, s))
                   for o, c, s in zip(offs, cdims, out.shape))
    sl_in = tuple(slice(0, s.stop - s.start) for s in sl_out)
    out[sl_out] = arr[sl_in]


def _read_layout(f: File, c: _Cursor, dt: np.dtype, shape, maxshape,
                 nbytes: int, filters, where: str) -> bytes:
    version, cls = c.u8(), c.u8()
    if version not in (3, 4):
        raise UnsupportedFeature(f"data layout message version {version}")
    if cls == 0:
        size = c.u16()
        data = c.take(size)
        if size < nbytes:
            raise HDF5FormatError(f"{where}: compact data too short")
        return data[:nbytes]
    if cls == 1:
        addr, size = c.addr(), c.length()
        if addr == f.undef:
            return bytes(nbytes)            # never written: fill value 0
        if size < nbytes:
            raise HDF5FormatError(f"{where}: contiguous data too short")
        return f.read_at(addr, nbytes)
    if cls != 2:
        raise UnsupportedFeature("virtual dataset layout" if cls == 3 else
                                 f"layout class {cls}")
    if not shape:
        raise HDF5FormatError(f"{where}: chunked scalar")
    out = np.zeros(shape, dt)
    rank = len(shape)
    if version == 3:
        ndims = c.u8()
        addr = c.addr()
        dims = [c.u32() for _ in range(ndims)]
        if ndims != rank + 1 or 0 in dims:
            raise HDF5FormatError(f"{where}: chunk rank")
        cdims = dims[:-1]
        _check_chunk(f, cdims, dt, where)
        if addr == f.undef:
            return out.tobytes()
        key = 8 + 8 * ndims
        cbytes = math.prod(cdims) * dt.itemsize
        for k, child in f._btree_leaves(addr, 1, key):
            size, mask = struct.unpack_from("<II", k)
            offs = struct.unpack_from(f"<{ndims}Q", k, 8)[:rank]
            chunk = _unfilter(f.read_at(child, size), filters, mask,
                              cbytes, where)
            _place(out, chunk, dt, cdims, offs, where)
        return out.tobytes()
    flags = c.u8()
    ndims = c.u8()
    enc = c.u8()
    if ndims != rank + 1 or not 1 <= enc <= 8:
        raise HDF5FormatError(f"{where}: chunk rank")
    dims = [c.uint(enc) for _ in range(ndims)]
    if 0 in dims:
        raise HDF5FormatError(f"{where}: zero chunk dimension")
    cdims = dims[:-1]
    _check_chunk(f, cdims, dt, where)
    cbytes = math.prod(cdims) * dt.itemsize
    # chunks in each dimension of the maximum shape (H5D__chunk_set_info's
    # max_chunks); indexes other than the extensible array and the v2
    # B-tree have no unlimited dimension
    max_grid = [None if m is None else -(-m // cd)
                for m, cd in zip(maxshape, cdims)]
    index = c.u8()

    def partial(offs):
        return any(o + cd > s for o, cd, s in zip(offs, cdims, shape))

    def get(addr, size, mask, scaled):
        offs = [i * cd for i, cd in zip(scaled, cdims)]
        if any(o >= s for o, s in zip(offs, shape)):
            return                          # beyond the current extent
        data = f.read_at(addr, size)
        if not (flags & 1 and partial(offs)):
            data = _unfilter(data, filters, mask, cbytes, where)
        _place(out, data, dt, cdims, offs, where)

    def unravel(i, grid):
        """Chunk coordinates of linear index ``i`` over ``grid``
        (row-major; the first extent may be None)."""
        scaled = []
        for g in reversed(grid[1:]):
            scaled.append(i % g)
            i //= g
        if grid[0] is not None and i >= grid[0]:
            raise HDF5FormatError(f"{where}: chunk index out of range")
        return [i] + scaled[::-1]

    if index in (1, 2, 3) and None in max_grid:
        raise HDF5FormatError(f"{where}: chunk index {index} with an "
                              "unlimited dimension")
    if index == 1:                          # single chunk
        fsize, fmask = cbytes, 0
        if flags & 2:
            fsize, fmask = c.length(), c.u32()
        addr = c.addr()
        if addr != f.undef:
            get(addr, fsize, fmask, [0] * rank)
    elif index == 2:                        # implicit
        addr = c.addr()
        if addr != f.undef:
            if filters:
                raise HDF5FormatError(f"{where}: implicit index with "
                                      "filters")
            for i in range(math.prod(max_grid)):
                get(addr + i * cbytes, cbytes, 0, unravel(i, max_grid))
    elif index == 3:                        # fixed array
        c.u8()                              # page bits (header repeats it)
        addr = c.addr()
        if addr != f.undef:
            for i, (a, size, mask) in enumerate(_fixed_array(
                    f, addr, math.prod(max_grid), cbytes)):
                if a != f.undef:
                    get(a, size, mask, unravel(i, max_grid))
    elif index == 4:                        # extensible array
        c.skip(5)                           # creation parameters (the
        addr = c.addr()                     # header repeats them)
        unlim = [i for i, g in enumerate(max_grid) if g is None]
        if len(unlim) != 1:
            raise HDF5FormatError(f"{where}: extensible-array index "
                                  f"with {len(unlim)} unlimited dimensions")
        u = unlim[0]
        # H5VM_swizzle_coords: the unlimited dimension is the slowest
        order = [u] + [d for d in range(rank) if d != u]
        grid = [max_grid[d] for d in order]
        if addr != f.undef:
            for i, (a, size, mask) in _extensible_array(f, addr, cbytes):
                if a == f.undef:
                    continue
                sw = unravel(i, grid)
                scaled = [0] * rank
                for d, v in zip(order, sw):
                    scaled[d] = v
                get(a, size, mask, scaled)
    elif index == 5:                        # v2 B-tree
        c.skip(6)                           # node size, split and merge
        addr = c.addr()
        if addr != f.undef:
            for rec in f.btree2(addr, 11 if filters else 10):
                r = _Cursor.over(rec, f.so, f.sl)
                a = r.addr()
                size, mask = cbytes, 0
                if filters:
                    nsize = len(rec) - f.so - 4 - 8 * rank
                    if not 1 <= nsize <= 8:
                        raise HDF5FormatError(f"{where}: v2 B-tree chunk "
                                              "record size")
                    size, mask = r.uint(nsize), r.u32()
                scaled = [r.uint(8) for _ in range(rank)]
                if r.pos != r.end:
                    raise HDF5FormatError(f"{where}: v2 B-tree chunk "
                                          "record size")
                if any(g is not None and v >= g
                       for v, g in zip(scaled, max_grid)):
                    raise HDF5FormatError(f"{where}: chunk {scaled} "
                                          "beyond the maximum shape")
                if a != f.undef:
                    get(a, size, mask, scaled)
    else:
        raise UnsupportedFeature(f"chunk index type {index}")
    return out.tobytes()


def _check_chunk(f: File, cdims, dt: np.dtype, where: str) -> None:
    # every chunk decodes from bytes of the file, and deflate, the
    # filter that expands most, stays under ~1032:1
    if math.prod(cdims) * dt.itemsize > 1100 * len(f.buf) + (1 << 20):
        raise HDF5FormatError(f"{where}: chunks of {cdims} elements in a "
                              f"file of {len(f.buf)} bytes")


def _chunk_elements(d: _Cursor, client: int, esize: int, n: int,
                    cbytes: int, so: int) -> list:
    """(address, stored size, filter mask) of ``n`` chunk entries of a
    fixed or extensible array (client 0: unfiltered, 1: filtered)."""
    out = []
    for _ in range(n):
        a = d.addr()
        if client == 1:
            size = d.uint(esize - so - 4)
            mask = d.u32()
        else:
            size, mask = cbytes, 0
        out.append((a, size, mask))
    return out


def _check_client(f: File, client: int, esize: int, what: str) -> None:
    if client not in (0, 1) or (client == 0 and esize != f.so) or \
            (client == 1 and not f.so + 5 <= esize <= f.so + 12):
        raise HDF5FormatError(f"{what} entry size")


def _bit(bitmap: bytes, i: int) -> bool:
    """H5VM_bit_get: bit ``i``, the most significant bit of a byte
    first."""
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def _checked_block(f: File, addr: int, n: int, what: str) -> _Cursor:
    """A cursor over ``n`` bytes at ``addr`` whose last 4 are their
    checksum."""
    c = f.cursor(addr, n + 4)
    body = c.buf[c.pos:c.pos + n]
    if len(body) != n or struct.unpack_from("<I", c.buf, c.pos + n)[0] != \
            lookup3(body):
        raise HDF5FormatError(f"{what} checksum mismatch")
    return _Cursor(f, c.pos, c.pos + n)


def _fixed_array(f: File, addr: int, nchunks: int, cbytes: int):
    c = f.cursor(addr)
    start = c.pos
    if c.take(4) != b"FAHD" or c.u8() != 0:
        raise HDF5FormatError("bad fixed-array header")
    client, esize, page_bits = c.u8(), c.u8(), c.u8()
    nent = c.length()
    dblk = c.addr()
    end = c.pos
    if c.u32() != lookup3(f.buf[start:end]):
        raise HDF5FormatError("fixed-array header checksum mismatch")
    if nent != nchunks or nent > MAX_ENTRIES:
        raise HDF5FormatError("fixed-array entry count")
    _check_client(f, client, esize, "fixed-array")
    if page_bits > 32:
        raise HDF5FormatError("fixed-array page size")
    page = 1 << page_bits
    npages = -(-nent // page) if nent > page else 0
    d = f.cursor(dblk)
    dstart = d.pos
    if d.take(4) != b"FADB" or d.u8() != 0 or d.u8() != client:
        raise HDF5FormatError("bad fixed-array data block")
    if d.addr() != addr:
        raise HDF5FormatError("fixed-array data block header address")
    if not npages:
        out = _chunk_elements(d, client, esize, nent, cbytes, f.so)
        if d.u32() != lookup3(f.buf[dstart:d.pos - 4]):
            raise HDF5FormatError("fixed-array data block checksum "
                                  "mismatch")
        return out
    # paged: a bitmap of the pages written, then each page with its own
    # checksum after the block's prefix
    init = d.take((npages + 7) // 8)
    if d.u32() != lookup3(f.buf[dstart:d.pos - 4]):
        raise HDF5FormatError("fixed-array data block checksum mismatch")
    out = []
    pos = dblk + (d.pos - dstart)
    for p in range(npages):
        n = min(page, nent - p * page)
        if _bit(init, p):
            pc = _checked_block(f, pos, n * esize, "fixed-array page")
            out += _chunk_elements(pc, client, esize, n, cbytes, f.so)
        else:
            out += [(f.undef, 0, 0)] * n
        pos += page * esize + 4
    return out


def _extensible_array(f: File, addr: int, cbytes: int):
    """(index, (address, stored size, filter mask)) of the chunks an
    extensible array holds: elements in its index block, then in data
    blocks, listed directly or through secondary blocks, paged or not
    (H5EA, the layout of HDF5's H5EAcache.c)."""
    c = f.cursor(addr)
    start = c.pos
    if c.take(4) != b"EAHD" or c.u8() != 0:
        raise HDF5FormatError("bad extensible-array header")
    client, esize, max_bits, iblk_elmts, dblk_min, sblk_min_ptrs, \
        page_bits = (c.u8() for _ in range(7))
    c.skip(4 * f.sl)                        # secondary/data block stats
    max_set, _nelmts, iblk = c.length(), c.length(), c.addr()
    if c.u32() != lookup3(f.buf[start:c.pos - 4]):
        raise HDF5FormatError("extensible-array header checksum mismatch")
    _check_client(f, client, esize, "extensible-array")
    if not 1 <= max_bits <= 64 or page_bits > 32 or max_set > MAX_ENTRIES:
        raise HDF5FormatError("extensible-array header")
    lg_dmin = _log2(dblk_min, "extensible-array data block minimum")
    lg_smin = _log2(sblk_min_ptrs, "extensible-array super block minimum")
    if lg_dmin > max_bits:
        raise HDF5FormatError("extensible-array header")
    page = 1 << page_bits
    off_size = (max_bits + 7) // 8
    # super block u: 2^(u//2) data blocks of 2^((u+1)//2) * dblk_min
    nsblks = 1 + max_bits - lg_dmin
    sblks, idx, dblk_no = [], 0, 0
    for u in range(nsblks):
        nd, ne = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
        sblks.append((idx, dblk_no, nd, ne))
        idx += nd * ne
        dblk_no += nd
    ib_sblks = 2 * lg_smin
    n_daddr = 2 * (sblk_min_ptrs - 1)
    if ib_sblks > nsblks:
        raise HDF5FormatError("extensible-array header")
    out: list = []
    if iblk == f.undef or max_set == 0:
        return out
    b = f.cursor(iblk)
    bstart = b.pos
    if b.take(4) != b"EAIB" or b.u8() != 0 or b.u8() != client or \
            b.addr() != addr:
        raise HDF5FormatError("bad extensible-array index block")
    elems = _chunk_elements(b, client, esize, iblk_elmts, cbytes, f.so)
    daddrs = [b.addr() for _ in range(n_daddr)]
    saddrs = [b.addr() for _ in range(nsblks - ib_sblks)]
    if b.u32() != lookup3(f.buf[bstart:b.pos - 4]):
        raise HDF5FormatError("extensible-array index block checksum "
                              "mismatch")
    out += list(enumerate(elems))[:max_set]

    def dblock(a: int, ne: int, init: bytes | None, base: int) -> None:
        """Elements of the data block at ``a`` holding indexes from
        ``base`` (``init``: its page bitmap, None when not paged)."""
        d = f.cursor(a)
        dstart = d.pos
        if d.take(4) != b"EADB" or d.u8() != 0 or d.u8() != client or \
                d.addr() != addr:
            raise HDF5FormatError("bad extensible-array data block")
        d.uint(off_size)
        if ne <= page:
            ents = _chunk_elements(d, client, esize, ne, cbytes, f.so)
            if d.u32() != lookup3(f.buf[dstart:d.pos - 4]):
                raise HDF5FormatError("extensible-array data block "
                                      "checksum mismatch")
            out.extend((base + k, e) for k, e in enumerate(ents)
                       if base + k < max_set)
            return
        if d.u32() != lookup3(f.buf[dstart:d.pos - 4]):
            raise HDF5FormatError("extensible-array data block checksum "
                                  "mismatch")
        pos = a + (d.pos - dstart)
        for p in range(ne // page):
            lo = base + p * page
            if lo >= max_set:
                break
            if init is None or _bit(init, p):
                pc = _checked_block(f, pos, page * esize,
                                    "extensible-array data block page")
                ents = _chunk_elements(pc, client, esize, page, cbytes,
                                       f.so)
                out.extend((lo + k, e) for k, e in enumerate(ents)
                           if lo + k < max_set)
            pos += page * esize + 4

    for u, (sidx, first, nd, ne) in enumerate(sblks):
        base = iblk_elmts + sidx
        if base >= max_set:
            break
        if u < ib_sblks:
            for k in range(nd):
                a = daddrs[first + k]
                if a != f.undef:
                    dblock(a, ne, None, base + k * ne)
            continue
        sa = saddrs[u - ib_sblks]
        if sa == f.undef:
            continue
        npages = ne // page if ne > page else 0
        s_ = f.cursor(sa)
        sstart = s_.pos
        if s_.take(4) != b"EASB" or s_.u8() != 0 or s_.u8() != client or \
                s_.addr() != addr:
            raise HDF5FormatError("bad extensible-array secondary block")
        s_.uint(off_size)
        isz = (npages + 7) // 8
        inits = [s_.take(isz) for _ in range(nd)] if npages else [None] * nd
        addrs = [s_.addr() for _ in range(nd)]
        if s_.u32() != lookup3(f.buf[sstart:s_.pos - 4]):
            raise HDF5FormatError("extensible-array secondary block "
                                  "checksum mismatch")
        for k in range(nd):
            if addrs[k] != f.undef:
                dblock(addrs[k], ne, inits[k], base + k * ne)
    return out


# ---------------------------------------------------------------------------
# writer: superblock 0, v1 object headers, symbol-table groups,
# contiguous datasets, version 1 attributes (h5py's default layout)
# ---------------------------------------------------------------------------

_UNDEF = b"\xff" * 8
_LEAF_K, _INTERNAL_K = 4, 16


def _pad8(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 8)


def _encode_dtype(dt: np.dtype) -> bytes:
    dt = np.dtype(dt)
    if dt.fields is not None:
        members = b""
        for name in dt.names:
            mdt, off = dt.fields[name][:2]
            members += (_pad8(name.encode() + b"\x00")
                        + struct.pack("<IB3xI4x16x", off, 0, 0)
                        + _encode_dtype(mdt))
        return struct.pack("<B3sI", 0x16,
                           len(dt.names).to_bytes(3, "little"),
                           dt.itemsize) + members
    order = 1 if dt.byteorder == ">" else 0
    if dt.kind in "iu":
        bits = order | (0x08 if dt.kind == "i" else 0)
        return struct.pack("<B3sIHH", 0x10, bits.to_bytes(3, "little"),
                           dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f":
        eloc, esize, bias = {4: (23, 8, 127), 8: (52, 11, 1023)}[
            dt.itemsize]
        bits = bytes([0x20 | order, 8 * dt.itemsize - 1, 0])
        return struct.pack("<B3sIHHBBBBI", 0x11, bits, dt.itemsize, 0,
                           8 * dt.itemsize, eloc, esize, 0, eloc, bias)
    if dt.kind == "S":
        return struct.pack("<B3sI", 0x13, b"\x01\x00\x00", dt.itemsize)
    raise ValueError(f"the writer does not encode dtype {dt}")


def _encode_space(shape: tuple) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", s) for s in shape)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _attr_message(name: str, value) -> bytes:
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        arr = np.asarray(arr.astype(object).tolist()
                         if arr.shape else str(arr).encode(), "S")
    nb = name.encode() + b"\x00"
    dt, sp = _encode_dtype(arr.dtype), _encode_space(arr.shape)
    data = (struct.pack("<BBHHH", 1, 0, len(nb), len(dt), len(sp))
            + _pad8(nb) + _pad8(dt) + _pad8(sp)
            + np.ascontiguousarray(arr).tobytes())
    return _message(0x0C, data)


class Chunked:
    """A dataset the writer stores in chunks (layout 3, a v1 B-tree chunk
    index) through a filter pipeline: ``chunks`` the chunk shape,
    ``filters`` ``(filter id, client data values)`` in pipeline order.
    The writer applies shuffle (2), deflate (1) and fletcher32 (3) itself;
    a pipeline with any other filter (VBZ, 32020) needs ``encode``, which
    turns one chunk's array, padded with zeros to the whole chunk, into
    its stored bytes."""

    def __init__(self, data, chunks, filters=(), encode=None):
        self.data = np.ascontiguousarray(data)
        self.chunks = tuple(int(c) for c in chunks)
        self.filters = tuple((int(fid), tuple(int(v) for v in cd))
                             for fid, cd in filters)
        self.encode = encode
        if len(self.chunks) != self.data.ndim or min(self.chunks) < 1:
            raise ValueError(f"chunks {self.chunks} for shape "
                             f"{self.data.shape}")
        if encode is None and any(f not in (1, 2, 3)
                                  for f, _ in self.filters):
            raise ValueError("the writer applies deflate, shuffle and "
                             "fletcher32; other filters need encode")

    def stored(self, chunk: np.ndarray) -> bytes:
        if self.encode is not None:
            return bytes(self.encode(chunk))
        data = chunk.tobytes()
        for fid, cd in self.filters:
            if fid == 2 and chunk.itemsize > 1:
                data = np.frombuffer(data, np.uint8).reshape(
                    -1, chunk.itemsize).T.tobytes()
            elif fid == 1:
                data = zlib.compress(data, cd[0] if cd else 6)
            elif fid == 3:
                data += struct.pack("<I", fletcher32(data))
        return data


def _filter_message(filters) -> bytes:
    names = {1: b"deflate", 2: b"shuffle", 3: b"fletcher32",
             VBZ_FILTER_ID: b"vbz"}
    out = struct.pack("<BB6x", 1, len(filters))
    for fid, cd in filters:
        name = _pad8(names.get(fid, b"") + b"\x00") if fid in names else b""
        out += struct.pack("<HHHH", fid, len(name), 0, len(cd)) + name
        out += b"".join(struct.pack("<I", v) for v in cd)
        out += bytes(4 * (len(cd) % 2))
    return out


class _Writer:
    def __init__(self):
        self.buf = bytearray(96)            # superblock, patched last

    def alloc(self, data: bytes) -> int:
        addr = len(self.buf)
        self.buf += _pad8(bytes(data))
        return addr

    def header(self, msgs: list[bytes]) -> int:
        body = b"".join(msgs)
        return self.alloc(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                      len(body)) + body)

    def chunk_btree(self, entries: list, key_dims: int) -> int:
        """A v1 B-tree of chunks (type 1, K = 32, HDF5's default) over
        ``entries`` [(key bytes, chunk address)] in chunk order, ending
        with the key after the last chunk; returns the root's address."""
        k2 = 2 * 32
        key_size = 8 + 8 * key_dims
        level, nodes = 0, entries[:-1]
        last_key = entries[-1][0]
        while True:
            groups = [nodes[i:i + k2] for i in range(0, len(nodes), k2)]
            size = 24 + (k2 + 1) * key_size + k2 * 8
            first = len(self.buf)
            addrs = [first + i * size for i in range(len(groups))]
            parents = []
            for gi, grp in enumerate(groups):
                right = groups[gi + 1][0][0] if gi + 1 < len(groups) \
                    else last_key
                body = b"TREE" + struct.pack(
                    "<BBH", 1, level, len(grp)) + (
                    struct.pack("<Q", addrs[gi - 1]) if gi else _UNDEF) + (
                    struct.pack("<Q", addrs[gi + 1])
                    if gi + 1 < len(groups) else _UNDEF)
                for key, child in grp:
                    body += key + struct.pack("<Q", child)
                body += right
                body += bytes(size - len(body))
                assert self.alloc(body) == addrs[gi]
                parents.append((grp[0][0], addrs[gi]))
            if len(parents) == 1:
                return parents[0][1]
            level, nodes = level + 1, parents

    def chunked(self, ch: Chunked, attrs: dict) -> int:
        arr = ch.data
        rank, cdims = arr.ndim, ch.chunks
        grid = [-(-s // c) for s, c in zip(arr.shape, cdims)]
        entries = []
        for idx in np.ndindex(*grid):
            offs = [i * c for i, c in zip(idx, cdims)]
            part = arr[tuple(slice(o, o + c) for o, c in zip(offs, cdims))]
            chunk = np.zeros(cdims, arr.dtype)
            chunk[tuple(slice(0, n) for n in part.shape)] = part
            data = ch.stored(chunk)
            key = struct.pack(f"<II{rank + 1}Q", len(data), 0, *offs, 0)
            entries.append((key, self.alloc(data)))
        if entries:
            end = [(i + 1) * c for i, c in zip(idx, cdims)]
            entries.append((struct.pack(f"<II{rank + 1}Q", 0, 0, *end,
                                        arr.itemsize), 0))
            btree = struct.pack("<Q", self.chunk_btree(entries, rank + 1))
        else:
            btree = _UNDEF
        layout = struct.pack("<BBB", 3, 2, rank + 1) + btree + struct.pack(
            f"<{rank + 1}I", *cdims, arr.itemsize)
        msgs = [_message(0x01, _encode_space(arr.shape)),
                _message(0x03, _encode_dtype(arr.dtype), flags=1),
                _message(0x05, bytes([2, 3, 2, 1, 0, 0, 0, 0]), flags=1),
                _message(0x08, layout)]
        if ch.filters:
            msgs.append(_message(0x0B, _filter_message(ch.filters)))
        msgs += [_attr_message(k, v) for k, v in attrs.items()]
        return self.header(msgs)

    def dataset(self, arr, attrs: dict) -> int:
        if isinstance(arr, Chunked):
            return self.chunked(arr, attrs)
        arr = np.ascontiguousarray(arr)
        data = arr.tobytes()
        daddr = self.alloc(data) if data else None
        layout = struct.pack("<BB", 3, 1) + (
            struct.pack("<Q", daddr) if daddr is not None else _UNDEF) + \
            struct.pack("<Q", len(data))
        msgs = [_message(0x01, _encode_space(arr.shape)),
                _message(0x03, _encode_dtype(arr.dtype), flags=1),
                _message(0x05, bytes([2, 2, 2, 1, 0, 0, 0, 0]), flags=1),
                _message(0x08, layout)]
        msgs += [_attr_message(k, v) for k, v in attrs.items()]
        return self.header(msgs)

    def group(self, children: dict[str, tuple[int, tuple | None]],
              attrs: dict) -> tuple[int, int, int]:
        """(header, B-tree, heap) addresses of a group whose children
        are {name: (header address, (btree, heap) of a group or None)}."""
        names = sorted(children, key=lambda s: s.encode())
        cap = 2 * _LEAF_K
        if len(names) > cap * 2 * _INTERNAL_K:
            raise ValueError("the writer puts at most 256 links in a group")
        heap_data = bytearray(8)            # offset 0: the empty name
        offs = {}
        for nm in names:
            offs[nm] = len(heap_data)
            heap_data += _pad8(nm.encode() + b"\x00")
        heap_data += bytes(16)              # a free block, as HDF5 keeps
        free = len(heap_data) - 16
        heap_data[free + 8:free + 16] = struct.pack("<Q", 16)
        heap_data[free:free + 8] = struct.pack("<Q", 1)
        data_addr = len(self.buf) + 32
        heap = self.alloc(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(heap_data), free, data_addr))
        assert heap + 32 == data_addr
        self.alloc(bytes(heap_data))
        snods = []
        for lo in range(0, max(len(names), 1), cap):
            part = names[lo:lo + cap]
            body = b"SNOD" + struct.pack("<BBH", 1, 0, len(part))
            for nm in part:
                hdr, cache = children[nm]
                body += struct.pack("<QQ", offs[nm], hdr)
                if cache is None:
                    body += bytes(24)
                else:
                    body += struct.pack("<I4xQQ", 1, *cache)
            body += bytes(40 * (cap - len(part)))
            snods.append((self.alloc(body), part))
        tree = b"TREE" + struct.pack("<BBH", 0, 0, len(snods)) + _UNDEF * 2
        tree += struct.pack("<Q", 0)
        for addr, part in snods:
            tree += struct.pack("<QQ", addr,
                                offs[part[-1]] if part else 0)
        tree += bytes(24 + (2 * _INTERNAL_K + 1) * 8
                      + 2 * _INTERNAL_K * 8 - len(tree))
        btree = self.alloc(tree)
        msgs = [_message(0x11, struct.pack("<QQ", btree, heap))]
        msgs += [_attr_message(k, v) for k, v in attrs.items()]
        return self.header(msgs), btree, heap


def write_file(path: str, tree: dict, root_attrs: dict | None = None
               ) -> None:
    """Write ``tree`` as an HDF5 file. ``tree`` maps names to either a
    dict (a group: its children, and attributes under the key
    ``"@attrs"``) or a tuple ``(array, attrs)``: a contiguous dataset, or
    a chunked one where the array is a ``Chunked``.
    Attribute values: numpy scalars or arrays of integers, floats or
    fixed-length bytes; ``np.bytes_`` gives a null-padded string."""
    w = _Writer()

    def emit(node: dict, attrs: dict):
        children = {}
        for name, child in node.items():
            if name == "@attrs":
                continue
            if "/" in name or not name:
                raise ValueError(f"bad link name {name!r}")
            if isinstance(child, dict):
                hdr, bt, hp = emit(child, child.get("@attrs", {}))
                children[name] = (hdr, (bt, hp))
            else:
                arr, dattrs = child
                if not isinstance(arr, Chunked):
                    arr = np.asarray(arr)
                children[name] = (w.dataset(arr, dattrs), None)
        return w.group(children, attrs)

    root, btree, heap = emit(tree, root_attrs or {})
    sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
          + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
          + struct.pack("<Q", 0) + _UNDEF
          + struct.pack("<Q", len(w.buf)) + _UNDEF
          + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
    w.buf[:96] = sb
    with open(path, "wb") as fh:
        fh.write(w.buf)
