"""deepsignal_plant_tpu_torch — the PyTorch/CUDA port of deepsignal_plant_tpu.

It runs the same per-site 5mC classifier on an NVIDIA H100. The JAX
package ``deepsignal_plant_tpu`` beside it stays the reference: this
package imports nothing of it (nor JAX) and keeps its own copies of the
host code it needs. Checkpoints and file formats are shared.

Ported so far: ``call_mods`` on a features TSV. Its BiLSTM layers run
through a hand-written Hopper kernel (``csrc/fused_bilstm.cu``), the
counterpart of the JAX package's Pallas kernel ``ops/pallas_fused.py``.
"""
from ._version import DEEPSIGNAL_PLANT_TPU_TORCH_VERSION as __version__
