"""Device and dtype resolution (counterpart of utils/jaxinit.py:56-96 and
of parallel/mesh.py's choice of devices: ``resolve_device`` for one card
a process, ``resolve_devices`` for the cards one process drives).

The port runs on the card unless the caller asks for the CPU: there is
no silent fallback, so a missing card is an error, not a slow run.
"""
from __future__ import annotations

import os

import torch


def _launched() -> bool:
    """True under a multi-process launch (WORLD_SIZE > 1)."""
    return int(os.environ.get("WORLD_SIZE", "") or 1) > 1


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (or "
            "resolve_device('cpu')) to run the plain PyTorch versions "
            "on the CPU")


def resolve_device(choice: str | None = None) -> torch.device:
    """``"cpu"`` -> the CPU (the plain PyTorch versions of every kernel);
    ``None`` or ``"cuda"`` -> the card: ``cuda:<LOCAL_RANK>`` under a
    multi-process launch (WORLD_SIZE > 1), the current device otherwise;
    ``"cuda:<n>"`` -> card n, for a caller that places ranks itself.
    Raises when the card is not there, and makes the card current."""
    if choice == "cpu":
        return torch.device("cpu")
    if choice is None or choice == "cuda":
        index = None
    elif choice.startswith("cuda:") and choice[5:].isdigit():
        index = int(choice[5:])
    else:
        raise ValueError(f"device must be cuda, cuda:<n> or cpu "
                         f"(got {choice!r})")
    _need_cuda()
    if index is None:
        if not _launched():
            return torch.device("cuda", torch.cuda.current_device())
        index = int(os.environ.get("LOCAL_RANK", "") or 0)
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"cuda:{index} does not exist ({torch.cuda.device_count()} "
            "card(s) visible): launch at most one rank per card")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def resolve_devices(choice: str | None = None) -> list[torch.device]:
    """The cards one process drives (call_mods, serve, train and
    denoise: one model replica a card; JAX ``make_mesh()`` over
    ``jax.local_devices()``): ``None`` or
    ``"cuda"`` -> every visible card, cuda:0 ... cuda:n-1
    (``CUDA_VISIBLE_DEVICES`` chooses them), card 0 made current; under
    a multi-process launch ``[cuda:<LOCAL_RANK>]``, one card a rank;
    ``"cuda:<n>"`` -> ``[cuda:n]``; ``"cpu"`` -> ``[cpu]``. Raises when
    the card is not there, as ``resolve_device`` does."""
    if choice not in (None, "cuda") or _launched():
        return [resolve_device(choice)]
    _need_cuda()
    torch.cuda.set_device(0)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_compute_dtype(choice: str, device: torch.device) -> str:
    """Map --compute_dtype auto|float32|bfloat16 to a concrete dtype.

    auto selects bfloat16 on the card (tensor-core operand type; the
    layer kernel keeps gate math and the cell state in f32) and float32
    on the CPU, as the JAX package does on TPU and on CPU."""
    if choice != "auto":
        return choice
    return "bfloat16" if device.type == "cuda" else "float32"


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
