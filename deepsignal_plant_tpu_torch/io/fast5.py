"""Single-read fast5 reading and writing, tombo-resquiggled layout
(counterpart of deepsignal_plant_tpu/io/fast5.py:26-270), on the port's
own HDF5 reader (io/hdf5.py): no h5py.

Group layout contract (reference extract_features.py:44-170,255-271):
    Raw/Reads/<Read_N>/Signal                    raw DAC samples
    Raw/Reads/<Read_N>@read_id                   read name
    Analyses/<corrected_group>/<subgroup>/Events fields start/length/base,
        attr read_start_rel_to_raw
    Analyses/<corrected_group>/<subgroup>/Alignment attrs
        mapped_strand / mapped_chrom / mapped_start
    UniqueGlobalKey/channel_id attrs digitisation / range / offset

The JAX package has two h5py readers, a fast one that falls back to a
slower one; this module has one. It reads what h5py reads in the fast5s
users have: VBZ-compressed signals (HDF5 filter 32020, decoded by
io/vbz.py against the system's libzstd.so.1), gzip, LZF, N-bit,
scale-offset and szip (io/h5filters.py), the layouts of
``libver="latest"`` files (dense groups and attributes, every chunk
index), enumerations and variable-length attributes, committed
datatypes and shared messages, soft and external links (a missing
channel group, or an external file missing, reads the raw signal
unscaled, as the JAX package's reader does). A VBZPluginError means
libzstd.so.1 is missing or the VBZ version is not one the port decodes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import hdf5
from .hdf5 import VBZPluginError  # noqa: F401  (re-exported)

READS_GROUP = "Raw/Reads"


class MultiReadFast5Error(ValueError):
    """Raised for multi-read fast5 containers. The pipeline (like the
    reference) works on single-read tombo-resquiggled fast5s; multi-read
    files must be converted first (reference README.md:177-188)."""


def _attr_str(v) -> str:
    """HDF5 attrs may be bytes or str depending on writer version
    (reference handles both, extract_features.py:109-127)."""
    if isinstance(v, bytes):
        return v.decode("utf-8")
    s = str(v)
    if s.startswith("b'"):
        return s.split("'")[1]
    return s


@dataclass
class TomboRead:
    """Everything needed from one resquiggled read."""
    readname: str
    read_strand: str        # 't' (template) or 'c' (complement)
    alignstrand: str        # '+' / '-'
    chrom: str
    chrom_start: int
    raw_signal: np.ndarray  # float64, channel-rescaled DAC
    event_starts: np.ndarray   # int64, absolute into raw_signal
    event_lengths: np.ndarray  # int64
    seq: str                # genome-aligned base sequence


def read_tombo_fast5(path: str,
                     corrected_group: str = "RawGenomeCorrected_000",
                     basecall_subgroup: str = "BaseCalled_template",
                     ) -> TomboRead | None:
    """Read one fast5; returns None when the read has no alignment group
    (reference's skip, extract_features.py:164-176). Raises on corrupt files
    (caller counts errors, extract_features.py:373)."""
    with hdf5.File(path) as h5:
        corr_path = f"Analyses/{corrected_group}/{basecall_subgroup}"
        if f"{corr_path}/Alignment" not in h5:
            # "not resquiggled" is a silent skip; a multi-read container
            # (top-level read_<uuid> groups, no Raw) needs conversion
            if "Raw" not in h5 and any(
                    k.startswith("read_") for k in h5.keys()):
                raise MultiReadFast5Error(
                    f"{path} is a multi-read fast5 container; this "
                    "pipeline (like the reference) reads single-read "
                    "tombo-resquiggled fast5s. Convert with "
                    "ont_fast5_api's multi_to_single_fast5, then "
                    "basecall and tombo resquiggle.")
            return None

        reads = h5[READS_GROUP].keys()
        if not reads:
            raise KeyError(f"{path}: no read under {READS_GROUP}")
        raw_grp = h5[f"{READS_GROUP}/{reads[0]}"]
        readname = _attr_str(raw_grp.attrs["read_id"])
        raw = raw_grp["Signal"][()]

        align_attrs = h5[f"{corr_path}/Alignment"].attrs
        alignstrand = _attr_str(align_attrs["mapped_strand"])
        chrom = _attr_str(align_attrs["mapped_chrom"])
        chrom_start = int(align_attrs["mapped_start"])
        read_strand = "t" if basecall_subgroup.endswith("template") else "c"

        events = h5[f"{corr_path}/Events"]
        rel = int(events.attrs["read_start_rel_to_raw"])
        table = events[()]
        starts = table["start"].astype(np.int64) + rel
        lengths = table["length"].astype(np.int64)
        bases = table["base"]
        seq = b"".join(bases).decode("utf-8") \
            if bases.dtype.kind == "S" else "".join(map(str, bases))

        # channel rescaling: scaling * (sig + offset)
        # (extract_features.py:255-274); missing channel info -> raw as-is
        try:
            ch = h5["UniqueGlobalKey/channel_id"].attrs
            scaling = float(ch["range"]) / float(ch["digitisation"])
            offset = float(ch["offset"])
            raw = np.asarray(scaling * (raw + offset), dtype=float)
        except KeyError:
            raw = np.asarray(raw, dtype=float)

    return TomboRead(readname, read_strand, alignstrand, chrom, chrom_start,
                     raw, starts, lengths, seq)


def write_tombo_fast5(path: str, readname: str, raw_signal: np.ndarray,
                      bases: str, event_starts: np.ndarray,
                      event_lengths: np.ndarray, chrom: str,
                      chrom_start: int, alignstrand: str = "+",
                      corrected_group: str = "RawGenomeCorrected_000",
                      basecall_subgroup: str = "BaseCalled_template",
                      digitisation: float = 8192.0, prange: float = 1465.0,
                      offset: float = 10.0,
                      read_start_rel_to_raw: int = 0,
                      signal_chunks: int | None = None,
                      signal_filters=(), signal_encode=None) -> None:
    """Create a minimal tombo-layout fast5 (test fixtures and format docs),
    in the layout h5py writes by default.

    ``raw_signal`` is stored as DAC integers; readers recover picoamps via
    the channel scaling attrs. It is stored contiguous, or with
    ``signal_chunks`` in chunks of that many samples through
    ``signal_filters`` ((filter id, client data values), as
    ``hdf5.Chunked``): ``((1, (4,)),)`` is gzip at level 4; a VBZ
    pipeline ``((32020, (0, 2, 1, 1)),)`` needs ``signal_encode``, a
    chunk's stored bytes from its int16 array.
    """
    n = len(bases)
    ev = np.zeros(n, dtype=[("start", "<i8"), ("length", "<i8"),
                            ("base", "S1")])
    ev["start"] = np.asarray(event_starts, dtype=np.int64)
    ev["length"] = np.asarray(event_lengths, dtype=np.int64)
    ev["base"] = np.frombuffer(bases.encode(), "S1")
    signal = np.asarray(raw_signal, dtype=np.int16)
    if signal_chunks is not None:
        signal = hdf5.Chunked(signal, (signal_chunks,), signal_filters,
                              signal_encode)
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
    hdf5.write_file(path, tree)
