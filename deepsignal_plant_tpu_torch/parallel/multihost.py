"""Collectives of multi-process runs (counterpart of
deepsignal_plant_tpu/parallel/multihost.py) on torch.distributed.

Every function here is a collective: each rank of the group calls it,
in the same order. They run on CUDA tensors of this rank's card under
NCCL and on CPU tensors under gloo (a group of one rank included);
without a process group they return at once.
Byte payloads travel as uint8 tensors and arrays as npz bytes (no
pickle).
"""
from __future__ import annotations

import io

import numpy as np
import torch

from .dist import group_running, process_info


def host_row_shard(n_rows: int, pid: int | None = None,
                   pcount: int | None = None) -> np.ndarray:
    """This rank's row indices (strided round-robin) of a dataset every
    rank loaded alike."""
    if pid is None or pcount is None:
        pid, pcount = process_info()
    return np.arange(pid, n_rows, pcount)


def comm_device() -> torch.device:
    """Where this group's collectives take their tensors: this rank's
    card under NCCL, the CPU otherwise."""
    import torch.distributed as tdist
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_sum(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise sums over ranks of float32 ``tensors``, in one
    all-reduce of their concatenation; each result on its input's device
    and in its shape. Every rank receives the same bytes."""
    if not group_running():
        return list(tensors)
    import torch.distributed as tdist
    dev = comm_device()
    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float32)
                      for t in tensors])
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM)
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape).to(t.device, t.dtype))
        off += n
    return out


def global_sum(values) -> np.ndarray:
    """Sum a small per-rank vector over ranks, in float64 (metric
    counts)."""
    v = np.asarray(values, np.float64)
    if not group_running():
        return v
    import torch.distributed as tdist
    t = torch.from_numpy(v.copy()).to(comm_device())
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return t.cpu().numpy()


def allgather_bytes(data: bytes, chunk_bytes: int = 256 << 20,
                    keep: bool = True) -> list[bytes]:
    """All-gather one variable-length byte payload per rank, returned in
    rank order. The sizes go first, as int64; then the payloads,
    zero-padded, in rounds of ``chunk_bytes``, so a round holds at most
    ``world * chunk_bytes`` in flight. A rank that only takes part to
    complete the collective passes ``keep=False``: it gets ``[]`` and
    never holds the other ranks' payloads."""
    if not group_running():
        return [data] if keep else []
    import torch.distributed as tdist
    _, pcount = process_info()
    dev = comm_device()
    n = len(data)
    sizes = [torch.zeros(1, dtype=torch.int64, device=dev)
             for _ in range(pcount)]
    tdist.all_gather(sizes, torch.tensor([n], dtype=torch.int64,
                                         device=dev))
    sizes = [int(s.item()) for s in sizes]
    src = np.frombuffer(data, np.uint8)
    out = [bytearray() for _ in range(pcount)] if keep else None
    for off in range(0, max(sizes), chunk_bytes):
        w = min(chunk_bytes, max(sizes) - off)
        buf = np.zeros(w, np.uint8)
        if off < n:
            k = min(w, n - off)
            buf[:k] = src[off:off + k]
        parts = [torch.empty(w, dtype=torch.uint8, device=dev)
                 for _ in range(pcount)]
        tdist.all_gather(parts, torch.from_numpy(buf).to(dev))
        if keep:
            for i, part in enumerate(parts):
                take = min(max(sizes[i] - off, 0), w)
                if take:
                    out[i] += part[:take].cpu().numpy().tobytes()
        del parts
    return [bytes(b) for b in out] if keep else []


def barrier() -> None:
    """Wait until every rank reaches this call."""
    if group_running():
        import torch.distributed as tdist
        tdist.barrier()


def broadcast_arrays(obj: dict | None, src: int = 0) -> dict:
    """Rank ``src``'s dict of numpy arrays on every rank (the other ranks
    pass None), sent as npz bytes: the size first, as int64, then the
    bytes. An empty dict stays empty."""
    if not group_running():
        return dict(obj)
    import torch.distributed as tdist
    pid, _ = process_info()
    dev = comm_device()
    if pid == src:
        fh = io.BytesIO()
        np.savez(fh, **obj)
        buf = torch.from_numpy(np.frombuffer(fh.getvalue(), np.uint8).copy())
        size = torch.tensor([buf.numel()], dtype=torch.int64, device=dev)
        buf = buf.to(dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    tdist.broadcast(size, src)
    if pid != src:
        buf = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    tdist.broadcast(buf, src)
    with np.load(io.BytesIO(buf.cpu().numpy().tobytes()),
                 allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
