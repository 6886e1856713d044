"""The multi-process runtime: launch environment, input sharding and
per-rank outputs (counterpart of deepsignal_plant_tpu/parallel/dist.py;
one process over several cards is parallel/mesh.py).

The port runs one process per card, started by ``torchrun`` (or any
launcher that sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK``): ``torchrun --nproc_per_node <cards>`` on
one node, and ``--nnodes``/``--node_rank``/``--rdzv_endpoint`` across
nodes. Rank ``r`` drives ``cuda:<LOCAL_RANK>``. The JAX package's
notions map onto ranks so:

- inference (``extract``, ``call_mods``, ``call_freq``): each rank is a
  JAX *host*. ``shard_for_host`` deals the sorted fast5 list round-robin
  over (``RANK``, ``WORLD_SIZE``), outputs take ``.host<RANK>``
  (``host_output_path``), and a features TSV or ``.npz`` input is not
  sharded: each rank calls all of it, as the JAX package does under a
  pod. call_freq merges its per-rank tables onto rank 0
  (pipeline/call_freq.merge_across_hosts).
- training: rank ``r`` is global device ``r`` of JAX's data-parallel
  axis, so a run of N ranks computes what the JAX package computes on
  N devices (one process over N devices, or N hosts of one device
  each): the sharded-resident plane deals contiguous row blocks, the
  host-fed plane strided row shards, and the step sums the weighted-CE
  terms and the gradients over ranks (pipeline/train.py).
- denoise: rank ``r`` is device ``r`` of the one process the JAX
  package's denoise runs over its local devices; rank 0 alone writes
  the files (pipeline/denoise.py).
- serve runs as one process (``refuse_launch``).

Collectives use NCCL between cards and gloo on the CPU, unless the
caller names a backend. Nothing falls back: a launch environment that
is incomplete, a ``LOCAL_RANK`` with no card or a missing NCCL raises.
"""
from __future__ import annotations

import os
import sys
from typing import Sequence, TypeVar

T = TypeVar("T")

#: what a launcher must set, besides WORLD_SIZE
LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, "") or default)


def _jax_pod_env() -> bool:
    """The JAX package's pod environment (JAX_COORDINATOR_ADDRESS with
    JAX_NUM_PROCESSES > 1)."""
    return bool(os.environ.get("JAX_COORDINATOR_ADDRESS")) and \
        _env_int("JAX_NUM_PROCESSES", 0) > 1


def pod_configured() -> bool:
    """True when a multi-process launch is configured (WORLD_SIZE > 1),
    without starting anything."""
    return _env_int("WORLD_SIZE", 1) > 1


def init_distributed(backend: str | None = None,
                     device: str | None = None) -> bool:
    """Start the process group of a multi-process launch; True when this
    call started it. Does nothing when ``WORLD_SIZE`` is 1 or unset, or
    when a group already runs. The backend is ``nccl`` unless ``device``
    is ``"cpu"`` (then ``gloo``) or the caller names one. The JAX
    package's pod variables without torch's raise: the run would
    otherwise go on as one process."""
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1:
        if _jax_pod_env():
            raise ValueError(
                "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES configure the "
                "JAX package's pod; deepsignal_plant_tpu_torch runs on "
                "torch.distributed: set MASTER_ADDR, MASTER_PORT, "
                "WORLD_SIZE, RANK and LOCAL_RANK (torchrun sets them)")
        return False
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return False
    start_group(backend or ("gloo" if device == "cpu" else "nccl"))
    return True


def start_group(backend: str) -> None:
    """Join the process group the launch environment describes, on
    ``backend``, at any world size (a one-rank group included). Under
    NCCL this rank's card is ``cuda:<LOCAL_RANK>`` and becomes current;
    a missing NCCL or a ``LOCAL_RANK`` without a card raises."""
    import torch
    import torch.distributed as tdist
    world = _env_int("WORLD_SIZE", 1)
    missing = [v for v in LAUNCH_VARS if not os.environ.get(v)]
    if missing:
        raise ValueError(
            "WORLD_SIZE={} but {} unset: launch with torchrun, or set "
            "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK"
            .format(world, ", ".join(missing)))
    if not tdist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    if backend == "nccl":
        if not tdist.is_nccl_available():
            raise RuntimeError(
                "NCCL is not available in this torch build; run on the "
                "CPU with --device cpu (gloo)")
        local = _env_int("LOCAL_RANK", 0)
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card ({torch.cuda.device_count()}"
                " visible): launch at most one rank per card")
        torch.cuda.set_device(local)
    tdist.init_process_group(
        backend, init_method="tcp://{}:{}".format(
            os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]),
        world_size=world, rank=_env_int("RANK", 0))


def group_running() -> bool:
    """A process group runs in this process (torch is imported only where
    it already was)."""
    if "torch" not in sys.modules:
        return False
    import torch.distributed as tdist
    return tdist.is_available() and tdist.is_initialized()


def destroy() -> None:
    """End the process group, if one runs."""
    if group_running():
        import torch.distributed as tdist
        tdist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a launch. A
    launch environment whose group was not started raises, so that no
    rank runs as if it were alone."""
    if group_running():
        import torch.distributed as tdist
        return tdist.get_rank(), tdist.get_world_size()
    if pod_configured() or _jax_pod_env():
        raise RuntimeError(
            "a multi-process launch is configured but torch.distributed "
            "is not initialized: call parallel.dist.init_distributed() "
            "first (the CLI does)")
    return 0, 1


def refuse_launch(command: str) -> None:
    """Raise under a multi-process launch: ``command`` runs as one
    process (serve watches one directory and answers each request on
    one card), so N ranks would each run the whole job and write the
    same paths."""
    rank, world = process_info()
    if world > 1:
        raise ValueError(
            f"{command} runs as one process on one card; this launch has "
            f"WORLD_SIZE={world} (rank {rank}): run it without torchrun")


def shard_for_host(items: Sequence[T], pid: int | None = None,
                   pcount: int | None = None) -> list[T]:
    """This rank's round-robin share of a work list, dealt over the
    sorted list so every rank agrees on the partition whatever order its
    directory listing gave. One process keeps the list as it is."""
    if pid is None or pcount is None:
        pid, pcount = process_info()
    if pcount == 1:
        return list(items)
    return [x for i, x in enumerate(sorted(items)) if i % pcount == pid]


def host_output_path(path: str) -> str:
    """``<root>.host<RANK><ext>`` under a launch, so ranks never write the
    same file (merged later by call_freq or the combine tools); the path
    itself in one process."""
    rank, world = process_info()
    if world == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.host{rank}{ext}"
