"""Device and dtype resolution (counterpart of utils/jaxinit.py:56-96 and,
for one process per card, parallel/mesh.py).

The port runs on the card unless the caller asks for the CPU: there is
no silent fallback, so a missing card is an error, not a slow run.
"""
from __future__ import annotations

import os

import torch


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
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (or "
            "resolve_device('cpu')) to run the plain PyTorch versions "
            "on the CPU")
    if index is None:
        if int(os.environ.get("WORLD_SIZE", "") or 1) <= 1:
            return torch.device("cuda", torch.cuda.current_device())
        index = int(os.environ.get("LOCAL_RANK", "") or 0)
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"cuda:{index} does not exist ({torch.cuda.device_count()} "
            "card(s) visible): launch at most one rank per card")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


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
