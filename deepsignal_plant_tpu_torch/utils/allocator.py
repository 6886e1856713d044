"""glibc's malloc thresholds for the host feed (counterpart of
deepsignal_plant_tpu/utils/jaxinit.py:9-33, ``tune_host_allocator``).

The TSV and fast5 planes allocate numpy blocks of 10-30 MB a parsed
block. glibc serves a block over ``M_MMAP_THRESHOLD`` (128 KB at start,
raised by glibc as it frees mmapped blocks, up to 32 MB) with a fresh
``mmap``: every block then pays soft page faults on first touch, and the
parser threads take the kernel's mmap lock in turn. Raising both the
mmap and the trim threshold to 256 MB keeps freed blocks on the heap for
the next block. The pipelines hold a bounded number of blocks, so the
heap they keep stays small. The JAX package calls this when its native
library loads and at every CLI entry; the port calls it when
``native.load()`` returns and in ``cli.main`` and ``serve``. It changes
where memory comes from, never a value.
"""
from __future__ import annotations

import ctypes

#: mallopt's parameter numbers (glibc malloc.h)
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
#: both thresholds, in bytes
THRESHOLD = 1 << 28

_tuned = False


def tune_host_allocator() -> bool:
    """Set glibc's mmap and trim thresholds to THRESHOLD, once a process:
    True when they are set (now or by an earlier call), False where there
    is no glibc ``mallopt`` or it refuses. Idempotent."""
    global _tuned
    if _tuned:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    _tuned = (bool(mallopt(M_MMAP_THRESHOLD, THRESHOLD))
              and bool(mallopt(M_TRIM_THRESHOLD, THRESHOLD)))
    return _tuned
