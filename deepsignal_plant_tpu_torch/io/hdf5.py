"""A read-only reader, and a small writer, for the part of HDF5 that
fast5 files use: what h5py reads in single-read tombo fast5s, whether
MinKNOW, ont_fast5_api, Guppy, tombo or h5py at ``libver="latest"``
wrote them. Python over numpy, struct and the standard library's zlib,
with the port's native library (native/featparse.cpp, built by g++ at
first use) for lookup3 and the bit-level filters (io/h5filters.py), and
VBZ through io/vbz.py (the system's libzstd.so.1 by ctypes). It imports
no h5py.

Names below are those of the *HDF5 File Format Specification Version
3.0*.

Reader (``File``): opens a file by path, resolves objects by path
(``"Analyses/RawGenomeCorrected_000/BaseCalled_template/Events"``) and
returns attributes and datasets as h5py does: numpy scalars or arrays,
a structured dtype for compound types, numpy bools for h5py's boolean
enumeration, object arrays of numpy arrays for variable-length
sequences (``bytes`` for variable-length strings, where h5py's
attributes give str). Links and attributes come in h5py's order:
creation order where the object tracks it, else name order. An
object's attributes are a read-only mapping that decodes a value only
when it is asked for. It reads

- superblock versions 0-3, with any size of offsets and lengths, and
  the superblock extension;
- object header versions 1 and 2 with continuation blocks (version 2
  checksums verified, Jenkins lookup3);
- old-style groups (symbol table message, v1 B-tree type 0, symbol
  nodes, local heap; soft links in entries of cache type 2) and
  new-style groups with compact Link messages or dense link storage;
- hard, soft and external links, resolved as HDF5 resolves them: a
  soft link's relative value from the group holding it, an external
  link's file by HDF5's default search, at most 16 soft and external
  links a path (H5L_NUM_LINKS);
- attribute messages versions 1-3, compact or in dense attribute
  storage, their datatypes and dataspaces shared or not;
- shared messages: in another object's header (committed datatypes)
  or in the shared object header message table's fractal heaps;
- dense storage: fractal heaps (managed objects in direct and indirect
  blocks, tiny objects, huge objects; through an I/O filter pipeline or
  not) and version 2 B-trees (record types 1, 2, 5, 6, 8 and 9 for heaps
  and groups, 10 and 11 for chunks);
- every datatype class h5py reads but time and references: integers of
  any precision and bit offset, bitfields, IEEE floats, fixed and
  variable-length strings and sequences (global heap collections),
  opaque, compound (member encodings 1-3, any member type), enumeration
  and array types;
- scalar and simple dataspaces, with maximum dimensions;
- data layout version 3 (compact, contiguous, chunked with a v1 B-tree
  type 1) and version 4 (compact, contiguous, chunked with a single
  chunk, implicit, fixed-array (paged or not), extensible-array or v2
  B-tree index);
- filter pipeline versions 1 and 2: deflate, shuffle, fletcher32, VBZ
  (filter 32020, version 0), LZF (32000), N-bit (5), scale-offset (6)
  and szip (4).

What it does not read raises ``UnsupportedFeature`` naming the feature,
only when that attribute, dataset or link is accessed: time datatypes,
object and region references, user-defined link classes, other
filters; VBZ raises ``VBZPluginError`` when libzstd.so.1 is missing or
its version is not 0. An external link to a file found nowhere raises
``ExternalFileMissing`` (a KeyError, as h5py's). Every address and
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
import os
import struct
import zlib
from collections.abc import Mapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
VBZ_FILTER_ID = 32020

#: bounds of every walk over file structures
MAX_BTREE_DEPTH = 32
MAX_NODES = 1 << 16
MAX_CONTINUATIONS = 1024
MAX_MESSAGES = 1 << 16        # header messages of one object
MAX_ENTRIES = 1 << 22         # B-tree entries of one walk
MAX_TYPE_DEPTH = 16           # nesting of compound, array, vlen, enum
MAX_SHARED_DEPTH = 8          # shared messages that point on to another
#: soft and external links one path may traverse (HDF5's H5L_NUM_LINKS)
MAX_LINKS = 16


class HDF5FormatError(ValueError):
    """The file is not HDF5 or its structures are corrupt."""


class UnsupportedFeature(HDF5FormatError):
    """The file uses a part of HDF5 this reader does not read."""

    def __init__(self, feature: str):
        super().__init__(f"unsupported HDF5 feature: {feature} (the "
                         "port's fast5 reader reads the subset of HDF5 "
                         "that single-read tombo fast5s use)")
        self.feature = feature


class ExternalFileMissing(KeyError):
    """An external link names a file found nowhere HDF5 looks (a
    KeyError, as h5py raises)."""

    def __init__(self, name: str, tried: list):
        super().__init__(f"external link to {name!r}: no such file (tried "
                         f"{', '.join(tried)})")


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
# checksums: Jenkins lookup3 (hashlittle) of version 2 structures,
# Fletcher-32 of the fletcher32 filter
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_native = None                # the port's native library, loaded once


def native():
    """The port's native library (native/featparse.cpp: lookup3, the
    filters' decoders, VBZ's Stream VByte), built by g++ at first use."""
    global _native
    if _native is None:
        from ..native import load
        _native = load()
    return _native


def lookup3(data: bytes, initval: int = 0) -> int:
    """Jenkins' lookup3 (hashlittle) of ``data`` (``dsp_lookup3``)."""
    return int(native().dsp_lookup3(bytes(data), len(data), initval))


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
        p = self.pos
        if n < 0 or p + n > self.end:
            raise HDF5FormatError(f"truncated structure at {p}")
        self.pos = p + n
        return int.from_bytes(self.buf[p:p + n], "little")

    def u8(self) -> int:
        p = self.pos
        if p >= self.end:
            raise HDF5FormatError(f"truncated structure at {p}")
        self.pos = p + 1
        return self.buf[p]

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

    def copy(self) -> "_Cursor":
        c = _Cursor.__new__(_Cursor)
        c.buf, c.pos, c.end, c.so, c.sl = (self.buf, self.pos, self.end,
                                           self.so, self.sl)
        return c


def _cstring(c: _Cursor, n: int | None) -> bytes:
    """A null-terminated string at ``c``: in a field of ``n`` bytes, or,
    with ``n`` None, up to and past its terminator."""
    if n is not None:
        return c.take(n).split(b"\x00", 1)[0]
    end = c.buf.find(b"\x00", c.pos, c.end)
    if end < 0:
        raise HDF5FormatError(f"unterminated string at {c.pos}")
    return c.take(end - c.pos + 1)[:-1]


def _attribute_name(c: _Cursor) -> str:
    """The name of the attribute message at ``c`` (``c`` not moved)."""
    if c.end - c.pos < 8 or c.buf[c.pos] not in (1, 2, 3):
        raise HDF5FormatError(f"attribute message at {c.pos}")
    head = 9 if c.buf[c.pos] == 3 else 8
    nsize = int.from_bytes(c.buf[c.pos + 2:c.pos + 4], "little")
    if c.pos + head + nsize > c.end:
        raise HDF5FormatError(f"attribute name past its message at {c.pos}")
    name = c.buf[c.pos + head:c.pos + head + nsize]
    return name.split(b"\x00", 1)[0].decode("utf-8", "replace")


class _Dtype:
    """A decoded datatype: ``np`` the numpy dtype of its stored bytes,
    ``out`` that of the values h5py returns, and ``conv`` the function
    from an array of stored elements to an array of values of the same
    shape (None where the two are the same). An array datatype's
    ``conv`` is its base type's, applied element by element."""
    __slots__ = ("np", "out", "conv")

    def __init__(self, npdt: np.dtype, out: np.dtype | None = None,
                 conv=None):
        self.np = npdt
        self.out = npdt if out is None else out
        self.conv = conv


def _array_of(base: _Dtype, dims: tuple) -> _Dtype:
    """An array datatype (class 10, or a version 1 compound member's
    dimensions) of ``dims`` elements of ``base``."""
    if not dims or 0 in dims or len(dims) > 32:
        raise HDF5FormatError(f"array datatype dimensions {dims}")
    return _Dtype(np.dtype((base.np, dims)), np.dtype((base.out, dims)),
                  base.conv)


def _bit_field(dt: np.dtype, off: int, prec: int, signed: bool):
    """The conversion of an integer stored in ``prec`` bits at bit
    ``off`` of ``dt`` to ``dt`` at full precision, sign-extended when
    signed (HDF5's H5T__conv_i_i into the native type of that size)."""
    udt = np.dtype(dt.str.replace("i", "u"))
    mask = np.uint64((1 << prec) - 1)

    def conv(a: np.ndarray) -> np.ndarray:
        v = (a.view(udt).astype(np.uint64) >> np.uint64(off)) & mask
        if signed and prec < 64:
            v = v.astype(np.int64)
            v = np.where(v >= 1 << (prec - 1), v - (1 << prec), v)
        return v.astype(dt)
    return conv


class _Message:
    __slots__ = ("mtype", "pos", "size", "flags", "corder")

    def __init__(self, mtype, pos, size, flags, corder=0):
        self.mtype, self.pos, self.size, self.flags = mtype, pos, size, flags
        self.corder = corder


class File:
    """An HDF5 file read whole into memory. ``f[path]`` gives a Group or
    a Dataset; ``path in f`` tests for one."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        with open(path, "rb") as fh:
            self.buf = fh.read()
        self._headers: dict[int, list] = {}
        self._links: dict[int, dict] = {}
        self._heaps: dict[int, dict] = {}
        self._fheaps: dict[int, _FractalHeap] = {}
        self._attr_order: dict[int, bool] = {}
        self._attr_index: dict[int, dict] = {}
        self._external: dict[str, File] = {}
        self._sohm: dict[int, int] | None = None
        self._ext_addr = None
        self._read_superblock()
        self.root = Group(self, self._root_addr, "/")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        """Drop the file's bytes, and close the files its external
        links opened."""
        self.buf = b""
        for ext in self._external.values():
            ext.close()
        self._external.clear()

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
            self._ext_addr = c.addr()       # superblock extension
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
        """A cursor over a message's body: where the message is shared,
        the body it points to."""
        c = _Cursor(self, m.pos, m.pos + m.size)
        return self._shared(c, m.mtype) if m.flags & 0x02 else c

    def _shared(self, c: _Cursor, mtype: int, depth: int = 0) -> _Cursor:
        """The body of the message of type ``mtype`` that the shared
        message encoding at ``c`` points to: in another object's header
        (a committed datatype; versions 1-3) or in the shared object
        header message heap (version 3, type 1)."""
        if depth > MAX_SHARED_DEPTH:
            raise HDF5FormatError("shared message chain too long")
        version, stype = c.u8(), c.u8()
        if version == 1:
            c.skip(6 + self.sl)             # reserved, a local heap address
        elif version not in (2, 3):
            raise HDF5FormatError(f"shared message version {version}")
        if version == 3 and stype == 1:
            return _Cursor.over(self._sohm_object(mtype, c.take(8)),
                                self.so, self.sl)
        if version == 3 and stype != 2:
            raise HDF5FormatError(f"shared message type {stype}")
        addr = c.addr()
        for m in self.messages(addr):
            if m.mtype == mtype:
                body = _Cursor(self, m.pos, m.pos + m.size)
                return self._shared(body, mtype, depth + 1) \
                    if m.flags & 0x02 else body
        raise HDF5FormatError(f"shared message of type {mtype} not in the "
                              f"object header at {addr}")

    def _sohm_object(self, mtype: int, hid: bytes) -> bytes:
        """A message in the shared object header message heap: the
        fractal heap of the index (superblock extension, shared message
        table ``SMTB``) that holds messages of type ``mtype``. The
        indexes themselves (lists or v2 B-trees of record type 7) serve
        writers looking for duplicates; a reader has the heap id."""
        if self._sohm is None:
            self._sohm = self._sohm_table()
        heap = self._sohm.get(mtype)
        if heap is None:
            raise HDF5FormatError(f"a shared message of type {mtype} and "
                                  "no shared message index for it")
        return self.fractal_heap(heap).object(hid)

    def _sohm_table(self) -> dict[int, int]:
        """message type -> fractal heap address of each index of the
        shared object header message table."""
        if self._ext_addr in (None, self.undef):
            raise HDF5FormatError("a shared message and no superblock "
                                  "extension")
        for m in self.messages(self._ext_addr):
            if m.mtype != 0x0F:
                continue
            c = _Cursor(self, m.pos, m.pos + m.size)
            if c.u8() != 0:
                raise HDF5FormatError("shared message table message version")
            addr, n = c.addr(), c.u8()
            t = self.cursor(addr)
            start = t.pos
            if t.take(4) != b"SMTB":
                raise HDF5FormatError(f"no shared message table at {addr}")
            out: dict[int, int] = {}
            for _ in range(n):
                if t.u8() != 0:
                    raise HDF5FormatError("shared message index version")
                t.u8()                      # list or v2 B-tree
                types = t.u16()
                t.skip(4 + 2 + 2 + 2)       # minimum size, cutoffs, count
                t.addr()                    # the index
                heap = t.addr()
                for mt in range(16):
                    if types & (1 << mt):
                        out.setdefault(mt, heap)
            if t.u32() != lookup3(self.buf[start:t.pos - 4]):
                raise HDF5FormatError("shared message table checksum "
                                      "mismatch")
            return out
        raise HDF5FormatError("a shared message and no shared message "
                              "table")

    # -- groups ---------------------------------------------------------
    def links(self, addr: int) -> dict[str, tuple]:
        """name -> link of a group, in the order h5py lists them:
        creation order where the group tracks it, else name order
        (bytes). A link is ``("hard", object header address)``,
        ``("soft", path)``, ``("external", (file name, object path))`` or
        ``("user", link class)``."""
        if addr not in self._links:
            self._links[addr] = self._read_links(addr)
        return self._links[addr]

    def _read_links(self, addr: int) -> dict[str, tuple]:
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

    def _link(self, c: _Cursor) -> tuple[int, str, tuple]:
        """(creation order, name, link) of a Link message."""
        if c.u8() != 1:
            raise HDF5FormatError("link message version")
        flags = c.u8()
        ltype = c.u8() if flags & 0x08 else 0
        corder = c.uint(8) if flags & 0x04 else 0
        if flags & 0x10:
            c.skip(1)
        name = c.take(c.uint(1 << (flags & 3))).decode("utf-8", "replace")
        if ltype == 0:
            return corder, name, ("hard", c.addr())
        if ltype == 1:
            return corder, name, ("soft", c.take(c.u16()).decode(
                "utf-8", "replace"))
        if ltype == 64:
            v = _Cursor.over(c.take(c.u16()), self.so, self.sl)
            if v.u8() != 0:
                raise HDF5FormatError("external link version or flags")
            target = (_cstring(v, None).decode("utf-8", "replace"),
                      _cstring(v, None).decode("utf-8", "replace"))
            return corder, name, ("external", target)
        return corder, name, ("user", ltype)

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

    def _symbol_table(self, btree: int, heap_addr: int) -> dict[str, tuple]:
        """name -> link of an old-style group's symbol table entries: a
        hard link, or with cache type 2 a soft link whose value lies in
        the group's local heap at the scratch pad's offset."""
        heap = self._local_heap(heap_addr)
        out: dict[str, tuple] = {}
        for _key, snod in self._btree_leaves(btree, 0, self.sl):
            c = self.cursor(snod)
            if c.take(4) != b"SNOD":
                raise HDF5FormatError(f"no symbol node at {snod}")
            c.skip(2)
            sl, so = self.sl, self.so
            for _ in range(c.u16()):
                e = c.take(sl + so + 24)    # cache type, reserved, scratch
                name_off = int.from_bytes(e[:sl], "little")
                obj = int.from_bytes(e[sl:sl + so], "little")
                cache = int.from_bytes(e[sl + so:sl + so + 4], "little")
                scratch = e[sl + so + 8:]
                name = self._heap_name(heap, name_off)
                if cache == 2:
                    out[name] = ("soft", self._heap_name(
                        heap, int.from_bytes(scratch[:4], "little")))
                elif cache in (0, 1):
                    out[name] = ("hard", obj)
                else:
                    raise HDF5FormatError(f"symbol table entry cache type "
                                          f"{cache}")
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
    def datatype(self, c: _Cursor, depth: int = 0) -> _Dtype:
        """The datatype message at ``c``: every class h5py reads but
        time, references and those of no class."""
        if depth > MAX_TYPE_DEPTH:
            raise HDF5FormatError("datatype nested too deep")
        cv = c.u8()
        cls, version = cv & 0x0F, cv >> 4
        bits = c.uint(3)
        size = c.u32()
        if size == 0 or size > (1 << 20):
            raise HDF5FormatError(f"datatype size {size}")
        if cls in (0, 4):                   # fixed-point, bitfield
            return self._fixed(c, bits, size, cls == 0 and bool(bits & 8))
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
        if cls == 5:                        # opaque
            tag = _cstring(c, bits & 0xFF)
            if tag.startswith(b"NUMPY:"):   # h5py's tag of numpy types
                try:
                    dt = np.dtype(tag[6:].decode("ascii"))
                except (TypeError, ValueError, UnicodeDecodeError):
                    dt = None
                if dt is not None and dt.itemsize == size:
                    return _Dtype(np.dtype(f"V{size}"), dt,
                                  lambda a, dt=dt: a.view(dt))
            return _Dtype(np.dtype(f"V{size}"))
        if cls == 6:                        # compound
            return self._compound(c, version, bits & 0xFFFF, size, depth)
        if cls == 8:                        # enumeration
            return self._enum(c, version, bits & 0xFFFF, size, depth)
        if cls == 9:                        # variable length
            return self._vlen(c, bits & 0x0F, size, depth)
        if cls == 10:                       # array
            ndims = c.u8()
            if version == 2:
                c.skip(3)
            elif version != 3:
                raise HDF5FormatError(f"array datatype version {version}")
            dims = tuple(c.u32() for _ in range(ndims))
            if version == 2:
                c.skip(4 * ndims)           # permutation indexes
            dt = _array_of(self.datatype(c, depth + 1), dims)
            if dt.np.itemsize != size:
                raise HDF5FormatError("array datatype size")
            return dt
        if cls == 7:
            raise UnsupportedFeature(("object", "region")[bits & 1]
                                     + " reference datatype")
        raise UnsupportedFeature("time datatype" if cls == 2 else
                                 f"datatype class {cls}")

    def _fixed(self, c: _Cursor, bits: int, size: int, signed: bool
               ) -> _Dtype:
        """An integer (or, unsigned, a bitfield, which h5py reads as the
        unsigned integer of its size) of any precision and bit offset."""
        off, prec = c.u16(), c.u16()
        if size not in (1, 2, 4, 8):
            raise UnsupportedFeature(f"{size}-byte integer")
        if prec == 0 or off + prec > 8 * size:
            raise HDF5FormatError(f"{prec}-bit integer at bit {off} in "
                                  f"{size} bytes")
        dt = np.dtype(f"{'>' if bits & 1 else '<'}{'iu'[not signed]}{size}")
        if off == 0 and prec == 8 * size:
            return _Dtype(dt)
        return _Dtype(dt, dt, _bit_field(dt, off, prec, signed))

    def _enum(self, c: _Cursor, version: int, n: int, size: int,
              depth: int) -> _Dtype:
        """h5py's values of an enumeration: numpy bools for its boolean
        (members exactly FALSE=0 and TRUE=1), else the base integers."""
        base = self.datatype(c, depth + 1)
        if base.np.kind not in "iu" or base.np.itemsize != size:
            raise HDF5FormatError("enumeration of a non-integer base")
        names = []
        for _ in range(n):
            start = c.pos
            names.append(_cstring(c, None))
            if version < 3:
                c.align(start)
        values = self.to_value(base, (n,), c.take(n * size)).tolist()
        if dict(zip(names, values)) == {b"FALSE": 0, b"TRUE": 1}:
            def to_bool(a, conv=base.conv):
                return (a if conv is None else conv(a)) != 0
            return _Dtype(base.np, np.dtype(bool), to_bool)
        members = {}
        for name, value in zip(names, values):
            try:
                name = name.decode("ascii")
            except UnicodeDecodeError:
                try:
                    name = name.decode("utf-8")
                except UnicodeDecodeError:
                    pass
            members[name] = value
        out = np.dtype(base.out.str, metadata={"enum": members})
        if base.conv is None:
            return _Dtype(out)
        return _Dtype(base.np, out, lambda a: base.conv(a).astype(out))

    def _vlen(self, c: _Cursor, vtype: int, size: int, depth: int
              ) -> _Dtype:
        """Variable-length strings (``bytes``) and sequences (h5py's
        object arrays of numpy arrays), each element a (length, global
        heap collection, object index) triple."""
        base = self.datatype(c, depth + 1)
        if size < 8 + self.so:
            raise HDF5FormatError(f"variable-length datatype of {size} "
                                  "bytes")
        stored = np.dtype(f"V{size}")
        if vtype == 1:
            return _Dtype(stored, np.dtype(object), self._vlen_str_values)
        if vtype != 0:
            raise HDF5FormatError(f"variable-length type {vtype}")

        def seqs(a):
            out = np.empty(a.shape, object)
            flat = out.reshape(-1)
            for i, obj in enumerate(self._vlen_objects(
                    a, base.np.itemsize)):
                flat[i] = self.to_value(base, (len(obj) // max(
                    base.np.itemsize, 1),), obj)
            return out
        return _Dtype(stored, np.dtype(object, metadata={"vlen": base.out}),
                      seqs)

    def _compound(self, c: _Cursor, version: int, nmembers: int,
                  size: int, depth: int) -> _Dtype:
        names, members, offsets = [], [], []
        off_bytes = 1 if size < 1 << 8 else 2 if size < 1 << 16 else \
            3 if size < 1 << 24 else 4
        for _ in range(nmembers):
            start = c.pos
            name = _cstring(c, None).decode("utf-8", "replace")
            if version in (1, 2):
                c.align(start)
                off = c.u32()
            elif version in (3, 4):         # 4 encodes members as 3
                off = c.uint(off_bytes)
            else:
                raise HDF5FormatError(f"compound datatype version "
                                      f"{version}")
            if version == 1:                # dimensions of an array member
                ndims = c.u8()
                c.skip(3 + 4 + 4)           # reserved, permutation
                dims = tuple(c.u32() for _ in range(4))[:ndims]
                mt = self.datatype(c, depth + 1)
                if ndims:
                    mt = _array_of(mt, dims)
            else:
                mt = self.datatype(c, depth + 1)
            if off + mt.np.itemsize > size:
                raise HDF5FormatError("compound member past its type")
            names.append(name)
            members.append(mt)
            offsets.append(off)

        def struct_dt(formats):
            try:
                return np.dtype({"names": names, "formats": formats,
                                 "offsets": offsets, "itemsize": size})
            except (ValueError, TypeError) as exc:
                raise HDF5FormatError(f"compound datatype: {exc}") from None
        dt = struct_dt([m.np for m in members])
        if all(m.conv is None for m in members):
            return _Dtype(dt)
        out = struct_dt([m.out for m in members])

        def conv(a):
            o = np.empty(a.shape, out)
            for name, m in zip(names, members):
                o[name] = a[name] if m.conv is None else m.conv(a[name])
            return o
        return _Dtype(dt, out, conv)

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
    def _vlen_objects(self, a: np.ndarray, esize: int) -> list[bytes]:
        """The bytes of each stored variable-length element of ``a`` (in
        C order): its length times ``esize`` bytes of its global heap
        object."""
        raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8).reshape(
            a.size, a.dtype.itemsize) if a.size else np.zeros((0, 16))
        out = []
        for e in raw:
            e = e.tobytes()
            length = int.from_bytes(e[:4], "little") * esize
            coll = int.from_bytes(e[4:4 + self.so], "little")
            index = int.from_bytes(e[4 + self.so:8 + self.so], "little")
            if length == 0:
                out.append(b"")
                continue
            obj = self._global_heap(coll).get(index)
            if obj is None or len(obj) < length:
                raise HDF5FormatError(f"global heap object {index} "
                                      "missing or short")
            out.append(obj[:length])
        return out

    def _vlen_str_values(self, a: np.ndarray) -> np.ndarray:
        out = np.empty(a.size, object)
        out[:] = self._vlen_objects(a, 1)
        return out.reshape(a.shape)

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
        """The value h5py gives for ``shape`` elements of ``dt`` stored
        in ``raw``: a numpy scalar (or, for variable-length types, the
        element itself) for a scalar, else an array; an array datatype's
        dimensions follow the dataspace's, as h5py returns them."""
        base, sub = (dt.np.base, dt.np.shape) if dt.np.subdtype else \
            (dt.np, ())
        arr = np.frombuffer(raw, base, count=math.prod(shape) * math.prod(
            sub)).reshape(tuple(shape) + sub)
        arr = arr.copy() if dt.conv is None else dt.conv(arr)
        return arr[()] if arr.ndim == 0 else arr

    def attribute_index(self, addr: int) -> dict:
        """name -> (cursor factory) of an object's attributes, in the
        order h5py lists them: creation order where the object tracks
        it, else name order (bytes). Only names are decoded here."""
        if addr in self._attr_index:
            return self._attr_index[addr]
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
                body = self._msg(m)
                found.append((m.corder, _attribute_name(body), body))
        if len(self._attr_index) > MAX_NODES:
            self._attr_index.clear()
        out = self._attr_index[addr] = _ordered(found, tracked)
        return out

    def _dense_attributes(self, heap: int, name_bt: int, order_bt: int,
                          tracked: bool) -> list:
        """Attributes held in a fractal heap, indexed by a v2 B-tree of
        name hashes (record type 8) or, where kept, of creation order
        (9); a shared one's record holds its id in the shared message
        heap."""
        fh = self.fractal_heap(heap)
        if tracked and order_bt != self.undef:
            recs = self.btree2(order_bt, 9)
        elif name_bt != self.undef:
            recs = self.btree2(name_bt, 8)
        else:
            raise HDF5FormatError("dense attributes without a name index")
        out = []
        for r in recs:
            data = self._sohm_object(0x0C, r[:8]) if r[8] & 0x02 else \
                fh.object(r[:8])
            body = _Cursor.over(data, self.so, self.sl)
            out.append((int.from_bytes(r[9:13], "little"),
                        _attribute_name(body), body))
        return out

    def attribute_value(self, c: _Cursor):
        """The value of the attribute message at ``c`` (a fresh cursor
        each call): None for a null dataspace."""
        version, flags = c.u8(), c.u8()
        nsize, tsize, ssize = c.u16(), c.u16(), c.u16()
        if version == 3:
            c.skip(1)

        def part(n):
            p = c.take(n)
            if version == 1:
                c.skip(-n % 8)
            return p
        part(nsize)
        tpart, spart = part(tsize), part(ssize)
        tc = _Cursor.over(tpart, self.so, self.sl)
        sc = _Cursor.over(spart, self.so, self.sl)
        if version > 1 and flags & 0x01:
            tc = self._shared(tc, 0x03)
        if version > 1 and flags & 0x02:
            sc = self._shared(sc, 0x01)
        dt = self.datatype(tc)
        shape = self.dataspace(sc)
        if shape is None:
            return None
        n = math.prod(shape)
        raw = c.take(n * dt.np.itemsize)
        return self.to_value(dt, shape, raw)

    # -- paths ----------------------------------------------------------
    def lookup(self, group: int, path: str, budget: list | None = None
               ) -> tuple["File", int]:
        """(file, object header address) of ``path`` from the group at
        ``group`` (from the root where the path is absolute), following
        soft and external links as HDF5 does (H5G_traverse): a soft
        link's relative value from the group holding it, at most
        MAX_LINKS soft and external links in all. KeyError where a link
        is missing, dangles or takes more links than that."""
        budget = [MAX_LINKS] if budget is None else budget
        parts = [p for p in path.split("/") if p and p != "."]
        f, addr = self, self._root_addr if path.startswith("/") else group
        for p in parts:
            f, addr = f._follow(addr, p, budget, path)
        return f, addr

    def _follow(self, group: int, name: str, budget: list, path: str
                ) -> tuple["File", int]:
        link = self.links(group).get(name)
        if link is None:
            raise KeyError(path)
        kind, value = link
        if kind == "hard":
            return self, value
        if kind == "user":
            raise UnsupportedFeature(f"user-defined link class {value} "
                                     f"({name!r})")
        budget[0] -= 1
        if budget[0] < 0:
            raise KeyError(f"{path}: more than {MAX_LINKS} soft or "
                           "external links (a cycle?)")
        if kind == "soft":
            return self.lookup(group, value, budget)
        ext = self._open_external(value[0])
        return ext.lookup(ext._root_addr, value[1], budget)

    def _open_external(self, name: str) -> "File":
        """The file an external link names, by HDF5's default search
        (H5F_prefix_open_file): an absolute name as given, then its last
        component as a relative name; a relative name in the linking
        file's directory, then in the working directory. Opened once,
        closed with this File."""
        cands = []
        if os.path.isabs(name):
            cands.append(name)
            name = os.path.basename(name)
        cands += [os.path.join(os.path.dirname(self.path), name),
                  os.path.abspath(name)]
        for cand in cands:
            key = os.path.abspath(cand)
            if key in self._external:
                return self._external[key]
            if os.path.isfile(key):
                if len(self._external) >= MAX_NODES:
                    raise HDF5FormatError("too many external files")
                ext = self._external[key] = File(key)
                return ext
        raise ExternalFileMissing(name, cands)

    def kind(self, addr: int) -> str:
        """"dataset", "datatype" (a committed one) or "group"."""
        kinds = {m.mtype for m in self.messages(addr)}
        if 0x08 in kinds:
            return "dataset"
        if 0x03 in kinds and not kinds & {0x02, 0x06, 0x11}:
            return "datatype"
        return "group"

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
    (record type 1, or 2 when filtered) or from the id itself. A heap
    with an I/O filter pipeline stores each direct block, and each huge
    object, through it: the root direct block's filtered size and mask
    in the header, each other's in its indirect block entry; a direct
    block's checksum covers its unfiltered bytes."""

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
        self.filters: list = []
        self.root_filtered = None
        if filter_len:
            self.root_filtered = (c.length(), c.u32())
            self.filters = _filter_pipeline(_Cursor.over(
                c.take(filter_len), f.so, f.sl))
            if not self.filters:
                raise HDF5FormatError("fractal heap with an empty filter "
                                      "pipeline")
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
        self._images: dict[int, bytes] = {}
        self._huge: dict | None = None

    def _row_size(self, r: int) -> int:
        return self.start_block << max(r - 1, 0)

    def blocks(self) -> list[tuple]:
        """(heap offset, file address, size, (filtered size, filter
        mask) or None) of every direct block."""
        if self._blocks is None:
            out: list = []
            if self.root != self.f.undef:
                if self.root_rows == 0:
                    out.append((0, self.root, self.start_block,
                                self.root_filtered))
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
        kids = []
        for i in range(nrows * self.width):
            direct = i // self.width < self.max_direct_rows
            kids.append((c.addr(), (c.length(), c.u32())
                         if direct and self.filters else None))
        if c.u32() != lookup3(f.buf[start:c.pos - 4]):
            raise HDF5FormatError("fractal heap indirect block checksum "
                                  "mismatch")
        for i, (kid, filtered) in enumerate(kids):
            r = i // self.width
            size = self._row_size(r)
            if kid != f.undef:
                if r < self.max_direct_rows:
                    out.append((off, kid, size, filtered))
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
        boff, baddr, bsize, filtered = blocks[lo - 1]
        if off + length > boff + bsize:
            raise HDF5FormatError(f"fractal heap object at {off} of "
                                  f"{length} bytes runs past its block")
        image, header = self._image(boff, baddr, bsize, filtered)
        if off - boff < header:
            raise HDF5FormatError(f"fractal heap object at {off} "
                                  "inside a block header")
        return image[off - boff:off - boff + length]

    def _image(self, boff: int, baddr: int, bsize: int, filtered):
        """(bytes, header length) of a direct block, unfiltered, its
        header and checksum verified once."""
        if baddr in self._images:
            return self._images[baddr]
        f = self.f
        if filtered is None:
            image = f.read_at(baddr, bsize)
        else:
            image = _unfilter(f.read_at(baddr, filtered[0]), self.filters,
                              filtered[1], bsize,
                              f"fractal heap direct block at {baddr}")
            if len(image) != bsize:
                raise HDF5FormatError(f"fractal heap direct block at {baddr}"
                                      f" unfilters to {len(image)} bytes, "
                                      f"not {bsize}")
        c = _Cursor.over(image, f.so, f.sl)
        self._block_offset(c, b"FHDB", baddr, boff)
        if self.dblock_checksums:
            at = c.pos
            stored = c.u32()
            block = bytearray(image)
            block[at:at + 4] = bytes(4)
            if stored != lookup3(bytes(block)):
                raise HDF5FormatError("fractal heap direct block "
                                      "checksum mismatch")
        self._images[baddr] = (image, c.pos)
        return self._images[baddr]

    def _huge_object(self, hid: bytes) -> bytes:
        """A huge object: its address and length (and, filtered, its
        filter mask and size) in the id itself when the id has room,
        else in a v2 B-tree record (type 1, or 2 when filtered) keyed by
        the id's number."""
        f = self.f
        where = f"huge fractal heap object in the heap at {self.addr}"
        fl = 4 + f.sl if self.filters else 0
        if self.id_len - 1 >= f.so + f.sl + fl:
            c = _Cursor.over(hid[1:], f.so, f.sl)
            entry = (c.addr(), c.length()) + (
                (c.u32(), c.length()) if fl else ())
        else:
            if self._huge is None:
                self._huge = {}
                if self.huge_bt != f.undef:
                    for r in f.btree2(self.huge_bt, 2 if fl else 1):
                        c = _Cursor.over(r, f.so, f.sl)
                        e = (c.addr(), c.length()) + (
                            (c.u32(), c.length()) if fl else ())
                        self._huge[c.length()] = e
            key = int.from_bytes(hid[1:1 + min(self.id_len - 1, 8)],
                                 "little")
            if key not in self._huge:
                raise HDF5FormatError(f"huge fractal heap object {key} "
                                      "missing")
            entry = self._huge[key]
        data = f.read_at(entry[0], entry[1])
        if not fl:
            return data
        out = _unfilter(data, self.filters, entry[2], entry[3], where)
        if len(out) != entry[3]:
            raise HDF5FormatError(f"{where} unfilters to {len(out)} bytes, "
                                  f"not {entry[3]}")
        return out

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


class Attributes(Mapping):
    """An object's attributes, read-only, in h5py's order. Names are
    read when the mapping is made; a value is decoded only when it is
    asked for, so an attribute of a type the reader refuses raises only
    on its own access."""

    def __init__(self, f: File, addr: int):
        self._file = f
        self._index = f.attribute_index(addr)

    def __getitem__(self, name: str):
        return self._file.attribute_value(self._index[name].copy())

    def __iter__(self):
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, name) -> bool:
        return name in self._index


class _Object:
    def __init__(self, f: File, addr: int, name: str):
        self.file, self.addr, self.name = f, addr, name

    @property
    def attrs(self) -> Attributes:
        return Attributes(self.file, self.addr)


class Group(_Object):
    def keys(self) -> list[str]:
        """Link names in h5py's order: creation order where the group
        tracks it, else byte order (HDF5's name index order); soft,
        external and user-defined links too."""
        return list(self.file.links(self.addr))

    def __getitem__(self, path: str):
        f, addr = self.file.lookup(self.addr, path)
        name = path if path.startswith("/") else \
            self.name.rstrip("/") + "/" + path.strip("/")
        kind = f.kind(addr)
        return (Dataset if kind == "dataset" else Datatype
                if kind == "datatype" else Group)(f, addr, name)

    def __contains__(self, path: str) -> bool:
        """h5py's test (h5g._path_valid): every link on the path exists
        and each but the last leads to a group; the last link itself is
        not followed, so a dangling one is in its group."""
        if not path:
            return False
        f, addr = self.file, (self.file._root_addr if path.startswith("/")
                              else self.addr)
        parts = [p for p in path.split("/") if p and p != "."]
        for i, p in enumerate(parts):
            if p not in f.links(addr):
                return False
            if i == len(parts) - 1:
                break
            try:
                f, addr = f._follow(addr, p, [MAX_LINKS], path)
            except KeyError:
                return False
            if f.kind(addr) != "group":
                return False
        return True


class Datatype(_Object):
    """A committed (named) datatype."""

    @property
    def dtype(self) -> np.dtype:
        for m in self.file.messages(self.addr):
            if m.mtype == 0x03:
                return self.file.datatype(self.file._msg(m)).out
        raise HDF5FormatError(f"{self.name}: no datatype message")


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
        raw = _read_layout(f, f._msg(layout), np.dtype(
            (np.void, dt.np.itemsize)), shape, maxshape, nbytes, filters,
            self.name)
        if shape == () or dt.conv is not None or dt.np.subdtype:
            return f.to_value(dt, shape, raw)
        return np.frombuffer(raw, dt.np, count=n).reshape(shape)

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
        elif fid in (4, 5, 6, 32000):
            from .h5filters import DECODERS
            data = DECODERS[fid](data, vals, expect, where)
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
