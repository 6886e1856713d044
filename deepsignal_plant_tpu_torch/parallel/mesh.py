"""The local cards of one process (counterpart of
deepsignal_plant_tpu/parallel/mesh.py).

The JAX package shards each batch ``P("dp")`` over a 1-D mesh of the
process's local devices, with the model replicated. The port has no mesh
object: it holds one model replica a card, cuts each batch into the
contiguous row ranges of ``shares`` and puts the results back in row
order.

- ``CallModsEngine`` (call_mods, serve): a batch of ``device_batch``
  rows gives each card the rows that ``P("dp")`` gives it; a shorter
  tail batch fills the first cards, as JAX's padded tail does, and
  leaves the last ones without rows (JAX gives them padding only; the
  port launches nothing there).
- train and denoise (pipeline/train.py ``Replicated``): the global batch
  is ``local_batch_target(batch_size, n)`` rows, each card's share a
  ``1/n`` of it, padded and masked at the epoch's tail so that every
  replica runs every step; a step sums the replicas' weighted-CE
  denominators, then their gradients and losses, with ``replica_sum``
  (JAX's ``psum`` over the mesh), and every replica takes the same
  update.
"""
from __future__ import annotations

import torch


def local_batch_target(device_batch: int, n: int) -> int:
    """A requested device batch rounded up to a multiple of the ``n``
    cards (JAX ``local_batch_target``)."""
    return -(-device_batch // n) * n


def shares(n_rows: int, device_batch: int, n: int) -> list[tuple[int, int]]:
    """Each card's row range ``[lo, hi)`` of a batch of ``n_rows`` rows
    (at most ``device_batch``, a multiple of ``n``): card ``i`` takes
    ``[i * s, (i + 1) * s)`` cut to the batch, ``s = device_batch // n``;
    a card past the batch's end gets an empty range."""
    if device_batch % n or n_rows > device_batch:
        raise ValueError(f"a batch of {n_rows} rows cannot be shared over "
                         f"{n} cards at device_batch {device_batch}")
    s = device_batch // n
    return [(min(i * s, n_rows), min((i + 1) * s, n_rows)) for i in range(n)]


def replica_sum(per_replica: list[list[torch.Tensor]]
                ) -> list[list[torch.Tensor]]:
    """The elementwise sums over a process's replicas of their tensors
    (``per_replica[i]``: replica i's list, the same shapes on every
    replica), the local counterpart of parallel/multihost.all_sum. Each
    replica's tensors go into one float32 vector; the vectors are added
    in replica order on replica 0's device, and every other replica gets
    a copy of the sum on its own device: the same bytes on every card,
    from any card count. Each replica's results are tensors of its own
    (``.to`` a device the sum is already on would return the sum itself,
    and two replicas on one card would share it), in its input's shapes
    and dtypes. One replica's list comes back as it is."""
    if len(per_replica) == 1:
        return [list(per_replica[0])]
    flats = [torch.cat([t.detach().reshape(-1).to(torch.float32)
                        for t in ts]) for ts in per_replica]
    total = flats[0]
    for flat in flats[1:]:
        total = total + flat.to(total.device)
    out = []
    for i, ts in enumerate(per_replica):
        flat = total if i == 0 else total.to(ts[0].device, copy=True)
        parts, off = [], 0
        for t in ts:
            parts.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
        out.append(parts)
    return out
