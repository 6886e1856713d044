"""deepsignal_plant_tpu_torch — the PyTorch/CUDA port of deepsignal_plant_tpu.

It runs the same per-site 5mC classifier on an NVIDIA H100. The JAX
package ``deepsignal_plant_tpu`` beside it stays the reference: this
package imports nothing of it (nor JAX) and keeps its own copies of the
host code it needs. Checkpoints and file formats are shared.

Every subcommand of the JAX package is ported: ``extract``,
``call_mods``, ``serve``, ``train``, ``denoise``, ``call_freq`` and the
``tools`` set, on one card or one process per card under ``torchrun``
(``parallel/``). Fast5s are read by the package's own HDF5 reader
(``io/hdf5.py``; no h5py). The BiLSTM layers run through hand-written
Hopper kernels: ``csrc/fused_bilstm.cu`` (K1, the counterpart of the
Pallas kernel ``ops/pallas_fused.py``) for inference and
``csrc/lstm_recurrence.cu`` (K2-K4, ``ops/pallas_lstm.py``) for
training.
"""
from ._version import DEEPSIGNAL_PLANT_TPU_TORCH_VERSION as __version__
