"""A frozen copy of the program's HDF5 writer
(deepsignal_plant_tpu_torch/io/hdf5.py::write_file and ``Chunked``, with
io/fast5.py::write_tombo_fast5's layout, as of this benchmark's fast5
cell): the benchmark writes its own fast5s, so that no later change to
the program can change the input. Chunked datasets take their chunks'
stored bytes from the caller (VBZ, lib/vbz.py); the program's copy also
applies deflate, shuffle and fletcher32, which no cell writes.

Superblock 0, version 1 object headers, symbol-table groups, contiguous
datasets, chunked datasets (layout 3, a v1 B-tree chunk index, a version
1 filter pipeline) and version 1 attributes: the layout h5py writes by
default.
"""
from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
VBZ_FILTER_ID = 32020

# ---------------------------------------------------------------------------
# writer: superblock 0, v1 object headers, symbol-table groups,
# contiguous and chunked datasets, version 1 attributes
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
    ``filters`` ``(filter id, client data values)`` in pipeline order, and
    ``encode``, which turns one chunk's array, padded with zeros to the
    whole chunk, into its stored bytes (VBZ: lib/vbz.py)."""

    def __init__(self, data, chunks, filters, encode):
        self.data = np.ascontiguousarray(data)
        self.chunks = tuple(int(c) for c in chunks)
        self.filters = tuple((int(fid), tuple(int(v) for v in cd))
                             for fid, cd in filters)
        self.encode = encode
        if len(self.chunks) != self.data.ndim or min(self.chunks) < 1:
            raise ValueError(f"chunks {self.chunks} for shape "
                             f"{self.data.shape}")

    def stored(self, chunk: np.ndarray) -> bytes:
        return bytes(self.encode(chunk))


def _filter_message(filters) -> bytes:
    names = {VBZ_FILTER_ID: b"vbz"}
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


def write_tombo_fast5(path: str, readname: str, raw_signal: np.ndarray,
                      bases: bytes, event_starts: np.ndarray,
                      event_lengths: np.ndarray, chrom: str,
                      chrom_start: int, alignstrand: str,
                      digitisation: float, prange: float, offset: float,
                      read_start_rel_to_raw: int, signal_chunks: int,
                      signal_filters, signal_encode,
                      corrected_group: str = "RawGenomeCorrected_000",
                      basecall_subgroup: str = "BaseCalled_template"
                      ) -> None:
    """A single-read tombo-resquiggled fast5: the raw DAC samples as int16
    in chunks of ``signal_chunks`` through ``signal_filters``
    (``signal_encode`` a chunk's stored bytes), the channel's scaling
    attributes, the event table (start, length, base) and the
    alignment's attributes."""
    n = len(bases)
    ev = np.zeros(n, dtype=[("start", "<i8"), ("length", "<i8"),
                            ("base", "S1")])
    ev["start"] = np.asarray(event_starts, dtype=np.int64)
    ev["length"] = np.asarray(event_lengths, dtype=np.int64)
    ev["base"] = np.frombuffer(bases, "S1")
    signal = Chunked(np.asarray(raw_signal, dtype=np.int16),
                     (signal_chunks,), signal_filters, signal_encode)
    tree = {
        "Raw": {"Reads": {"Read_0": {
            "@attrs": {"read_id": np.bytes_(readname)},
            "Signal": (signal, {})}}},
        "UniqueGlobalKey": {"channel_id": {"@attrs": {
            "digitisation": np.float64(digitisation),
            "range": np.float64(prange), "offset": np.float64(offset)}}},
        "Analyses": {corrected_group: {basecall_subgroup: {
            "Alignment": {"@attrs": {
                "mapped_strand": np.bytes_(alignstrand),
                "mapped_chrom": np.bytes_(chrom),
                "mapped_start": np.int64(chrom_start)}},
            "Events": (ev, {"read_start_rel_to_raw":
                            np.int64(read_start_rel_to_raw)})}}},
    }
    write_file(path, tree)
