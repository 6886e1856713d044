"""The local cards of one process (counterpart of
deepsignal_plant_tpu/parallel/mesh.py).

The JAX package's inference engine shards each device batch's sites
``P("dp")`` over a 1-D mesh of the process's local devices, with the
model replicated. The port has no mesh object: ``CallModsEngine`` holds
one model replica and one feed per card, cuts each batch into the
contiguous row ranges of ``shares`` and puts the probabilities back in
row order. A batch of ``device_batch`` rows gives each card the rows
that ``P("dp")`` gives it; a shorter tail batch fills the first cards,
as JAX's padded tail does, and leaves the last ones without rows (JAX
gives them padding only; the port launches nothing there).
"""
from __future__ import annotations


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
