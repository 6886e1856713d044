"""Device and dtype resolution (counterpart of utils/jaxinit.py:56-96).

The port runs on the card unless the caller asks for the CPU: there is
no silent fallback, so a missing card is an error, not a slow run.
"""
from __future__ import annotations

import torch


def resolve_device(choice: str | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device, raising when no
    card is present; ``"cpu"`` -> the CPU (the plain PyTorch versions of
    every kernel)."""
    if choice == "cpu":
        return torch.device("cpu")
    if choice not in (None, "cuda"):
        raise ValueError(f"device must be cuda or cpu (got {choice!r})")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (or "
            "resolve_device('cpu')) to run the plain PyTorch versions "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


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
