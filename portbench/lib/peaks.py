"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W; a card set below that limit
runs slower under load, so the card's power limit is written beside
every share).

Products of 32-bit operands are measured against the TF32 tensor-core
rate, the chip's highest for them: the count is then of the same work
whatever implements it (a correct 3xTF32 route reaches at most a third
of it, plain CUDA-core FMAs about 67 TFLOP/s)."""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}
