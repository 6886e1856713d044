"""A read-only reader, and a small writer, for the part of HDF5 that
single-read tombo fast5 files use. Pure Python: numpy, struct and the
standard library's zlib. It imports no h5py.

Names below are those of the *HDF5 File Format Specification Version
3.0*.

Reader (``File``): opens a file by path, resolves objects by path
(``"Analyses/RawGenomeCorrected_000/BaseCalled_template/Events"``) and
returns attributes (numpy scalars or arrays; ``bytes`` for
variable-length strings) and datasets (numpy arrays; a structured dtype
for compound types). It reads

- superblock versions 0-3, with any size of offsets and lengths;
- object header versions 1 and 2 with continuation blocks (version 2
  checksums verified, Jenkins lookup3);
- old-style groups (symbol table message, v1 B-tree type 0, symbol
  nodes, local heap) and new-style groups with compact Link messages;
- attribute messages versions 1-3;
- fixed-point, IEEE float, fixed and variable-length strings (global
  heap collections), compound types (member encodings 1-3);
- scalar and simple dataspaces;
- data layout version 3 (compact, contiguous, chunked with a v1 B-tree
  type 1) and version 4 (compact, contiguous, chunked with a single
  chunk, implicit or unpaged fixed-array index);
- filter pipeline versions 1 and 2: deflate, shuffle and fletcher32.

What it does not read raises ``UnsupportedFeature`` naming the feature:
dense link or attribute storage (fractal heaps), paged fixed arrays,
extensible-array and v2 B-tree chunk indexes, shared messages, other
datatype classes, and other filters; VBZ (filter 32020) raises
``VBZPluginError``. Every address and length is checked against the
file's size and every walk is bounded, so a corrupt file raises
``HDF5FormatError`` (a ValueError) instead of hanging.

Writer (``write_file``): superblock 0, version 1 object headers,
symbol-table groups, contiguous datasets and version 1 attributes -- the
layout h5py writes by default for the tombo fixture.
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
    """A dataset is VBZ-compressed (HDF5 filter 32020)."""

    def __init__(self, where: str = ""):
        HDF5FormatError.__init__(
            self, f"{where}VBZ-compressed data (HDF5 filter "
            f"{VBZ_FILTER_ID}): the port's fast5 reader does not decode "
            "VBZ (zstd is not in Python's standard library). Convert the "
            "fast5s without VBZ (ont_fast5_api compress_fast5 -c gzip), or "
            "read them with the JAX package deepsignal_plant_tpu and ONT's "
            "vbz plugin")
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
    __slots__ = ("mtype", "pos", "size", "flags")

    def __init__(self, mtype, pos, size, flags):
        self.mtype, self.pos, self.size, self.flags = mtype, pos, size, flags


class File:
    """An HDF5 file read whole into memory. ``f[path]`` gives a Group or
    a Dataset; ``path in f`` tests for one."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            self.buf = fh.read()
        self._headers: dict[int, list] = {}
        self._links: dict[int, dict] = {}
        self._heaps: dict[int, dict] = {}
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
        blocks = [(lo, lo + size)]
        msgs: list[_Message] = []
        seen = {start - self.base}
        while blocks:
            blo, bhi = blocks.pop(0)
            b = _Cursor(self, blo, bhi)
            hdr = 6 if order else 4
            while b.end - b.pos >= hdr:
                mtype, msize, mflags = b.u8(), b.u16(), b.u8()
                if order:
                    b.skip(2)
                pos = b.pos
                b.skip(msize)
                msgs.append(_Message(mtype, pos, msize, mflags))
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
        """name -> object header address of a group's hard links."""
        if addr not in self._links:
            self._links[addr] = self._read_links(addr)
        return self._links[addr]

    def _read_links(self, addr: int) -> dict[str, int]:
        msgs = self.messages(addr)
        out: dict[str, int] = {}
        for m in msgs:
            if m.mtype == 0x11:
                c = self._msg(m)
                btree, heap = c.addr(), c.addr()
                return self._symbol_table(btree, heap)
        for m in msgs:
            if m.mtype == 0x02:
                c = self._msg(m)
                if c.u8() != 0:
                    raise HDF5FormatError("link info message version")
                fl = c.u8()
                if fl & 1:
                    c.skip(8)
                if c.addr() != self.undef:
                    raise UnsupportedFeature(
                        "dense link storage (fractal heap)")
            elif m.mtype == 0x06:
                name, target = self._link(self._msg(m))
                out[name] = target
        return out

    def _link(self, c: _Cursor):
        if c.u8() != 1:
            raise HDF5FormatError("link message version")
        flags = c.u8()
        ltype = c.u8() if flags & 0x08 else 0
        if flags & 0x04:
            c.skip(8)
        if flags & 0x10:
            c.skip(1)
        name = c.take(c.uint(1 << (flags & 3))).decode("utf-8", "replace")
        if ltype == 0:
            return name, c.addr()
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

    def dataspace(self, c: _Cursor):
        """The shape: ``()`` for a scalar, None for a null dataspace."""
        version = c.u8()
        rank = c.u8()
        c.u8()                              # flags (maximum dims follow)
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
            return None
        dims = tuple(c.length() for _ in range(rank))
        return dims if kind == 1 else ()

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
        out = {}
        for m in self.messages(addr):
            if m.mtype == 0x15:
                c = self._msg(m)
                if c.u8() != 0:
                    raise HDF5FormatError("attribute info version")
                if c.u8() & 1:
                    c.skip(2)
                if c.addr() != self.undef:
                    raise UnsupportedFeature(
                        "dense attribute storage (fractal heap)")
            elif m.mtype == 0x0C:
                name, value = self._attribute(self._msg(m))
                out[name] = value
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


class _Object:
    def __init__(self, f: File, addr: int, name: str):
        self.file, self.addr, self.name = f, addr, name

    @property
    def attrs(self) -> dict:
        return self.file.attributes(self.addr)


class Group(_Object):
    def keys(self) -> list[str]:
        """Link names in byte order (HDF5's name index order)."""
        return sorted(self.file.links(self.addr),
                      key=lambda s: s.encode("utf-8"))

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
                shape = f.dataspace(f._msg(m))
            elif m.mtype == 0x08:
                layout = m
            elif m.mtype == 0x0B:
                filters = _filter_pipeline(f._msg(m))
        if dt is None or layout is None:
            raise HDF5FormatError(f"{self.name}: no datatype or layout")
        if shape is None:
            raise UnsupportedFeature("null dataspace dataset")
        return dt, shape, layout, filters

    def read(self) -> np.ndarray:
        f = self.file
        dt, shape, layout, filters = self._meta()
        n = math.prod(shape)
        nbytes = n * dt.np.itemsize
        # deflate expands at most ~1032:1; nothing this file holds can
        # decode to more
        if nbytes > 1100 * len(f.buf) + (1 << 20):
            raise HDF5FormatError(f"{self.name}: {nbytes} bytes of data "
                                  f"in a file of {len(f.buf)}")
        raw = _read_layout(f, f._msg(layout), dt.np, shape, nbytes,
                           filters, self.name)
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
            raise VBZPluginError(f"{where}: ")
        else:
            raise UnsupportedFeature(f"filter {fid} ({name or 'unnamed'})")
    return data


def _chunk_grid(shape, cdims):
    return tuple(-(-s // c) for s, c in zip(shape, cdims))


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


def _read_layout(f: File, c: _Cursor, dt: np.dtype, shape, nbytes: int,
                 filters, where: str) -> bytes:
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
    cbytes = math.prod(cdims) * dt.itemsize
    grid = _chunk_grid(shape, cdims)
    index = c.u8()
    names = {4: "extensible-array chunk index (a dataset with an "
                "unlimited dimension)",
             5: "v2 B-tree chunk index (a dataset with several unlimited "
                "dimensions)"}
    if index in names:
        raise UnsupportedFeature(names[index])

    def partial(offs):
        return any(o + cd > s for o, cd, s in zip(offs, cdims, shape))

    def get(addr, size, mask, offs):
        data = f.read_at(addr, size)
        if not (flags & 1 and partial(offs)):
            data = _unfilter(data, filters, mask, cbytes, where)
        _place(out, data, dt, cdims, offs, where)

    def offsets(i):
        offs = []
        for g, cd in zip(reversed(grid), reversed(cdims)):
            offs.append((i % g) * cd)
            i //= g
        return offs[::-1]

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
            for i in range(math.prod(grid)):
                get(addr + i * cbytes, cbytes, 0, offsets(i))
    elif index == 3:                        # fixed array
        c.u8()                              # page bits (header repeats it)
        addr = c.addr()
        if addr != f.undef:
            for i, (a, size, mask) in enumerate(
                    _fixed_array(f, addr, math.prod(grid), cbytes)):
                if a != f.undef:
                    get(a, size, mask, offsets(i))
    else:
        raise UnsupportedFeature(f"chunk index type {index}")
    return out.tobytes()


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
    if nent != nchunks:
        raise HDF5FormatError("fixed-array entry count")
    if nent > (1 << page_bits):
        raise UnsupportedFeature("paged fixed-array chunk index")
    if client not in (0, 1) or (client == 0 and esize != f.so) or \
            (client == 1 and esize <= f.so + 4):
        raise HDF5FormatError("fixed-array entry size")
    d = f.cursor(dblk)
    dstart = d.pos
    if d.take(4) != b"FADB" or d.u8() != 0 or d.u8() != client:
        raise HDF5FormatError("bad fixed-array data block")
    if d.addr() != addr:
        raise HDF5FormatError("fixed-array data block header address")
    out = []
    for _ in range(nent):
        a = d.addr()
        if client == 1:
            size = d.uint(esize - f.so - 4)
            mask = d.u32()
        else:
            size, mask = cbytes, 0
        out.append((a, size, mask))
    dend = d.pos
    if d.u32() != lookup3(f.buf[dstart:dend]):
        raise HDF5FormatError("fixed-array data block checksum mismatch")
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

    def dataset(self, arr: np.ndarray, attrs: dict) -> int:
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
    ``"@attrs"``) or a tuple ``(array, attrs)`` (a contiguous dataset).
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
                children[name] = (w.dataset(np.asarray(arr), dattrs), None)
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
