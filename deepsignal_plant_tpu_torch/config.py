"""Typed configuration objects (counterpart of deepsignal_plant_tpu/config.py).

``ModelConfig`` has the JAX package's fields and properties, so one
checkpoint's embedded ``__config__`` builds either package's model. Only
``recurrence`` differs in its values: ``"scan"`` runs the plain PyTorch
loop (ops/lstm.py) and ``"kernel"`` the hand-written CUDA layer kernel
(ops/fused_lstm.py). The JAX package's ``"pallas"`` names the same fused
layer and maps to ``"kernel"``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace

MODULE_TYPES = ("both_bilstm", "seq_bilstm", "signal_bilstm")
RECURRENCES = ("scan", "kernel")


@dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of ModelBiLSTM (reference ctor models.py:103-106)."""
    seq_len: int = 13
    signal_len: int = 16
    num_layers_comb: int = 3      # reference --layernum1
    num_layers_branch: int = 1    # reference --layernum2
    num_classes: int = 2
    dropout_rate: float = 0.5
    hidden_size: int = 256
    vocab_size: int = 16
    embedding_size: int = 4
    is_base: bool = True
    is_signallen: bool = True
    module: str = "both_bilstm"
    compute_dtype: str = "float32"  # "float32" or "bfloat16"
    recurrence: str = "kernel"      # "scan" (plain loop) | "kernel"

    def __post_init__(self):
        if self.module not in MODULE_TYPES:
            raise ValueError(f"module must be one of {MODULE_TYPES}")
        if self.recurrence not in RECURRENCES:
            raise ValueError(f"recurrence must be one of {RECURRENCES} "
                             "(map 'pallas' and 'auto' with "
                             "resolve_recurrence first)")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be 'float32' or "
                             "'bfloat16' (resolve 'auto' via "
                             "utils.device.resolve_compute_dtype first)")

    @property
    def nhid_seq(self) -> int:
        if self.module == "seq_bilstm":
            return self.hidden_size
        return self.hidden_size // 2

    @property
    def nhid_signal(self) -> int:
        if self.module == "signal_bilstm":
            return self.hidden_size
        return self.hidden_size - self.hidden_size // 2

    @property
    def sigfea_num(self) -> int:
        return 3 if self.is_signallen else 2

    @property
    def seq_input_size(self) -> int:
        base = self.embedding_size if self.is_base else 0
        return base + self.sigfea_num

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def to_json_dict(self) -> dict:
        """Fields as the JAX package's ModelConfig accepts them (its
        recurrence values are scan|pallas)."""
        d = dataclasses.asdict(self)
        if d["recurrence"] == "kernel":
            d["recurrence"] = "pallas"
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "ModelConfig":
        """Inverse of to_json_dict; reads either package's config."""
        d = dict(d)
        d["recurrence"] = resolve_recurrence(d.get("recurrence", "kernel"))
        return cls(**d)


def resolve_recurrence(choice: str) -> str:
    """Map --recurrence auto|scan|kernel|pallas to scan|kernel. auto is
    the kernel: on CPU tensors its wrapper runs the plain version."""
    return "kernel" if choice in ("auto", "pallas") else choice


@dataclass(frozen=True)
class CallConfig:
    """Inference-engine settings of the features-TSV plane."""
    # sites parsed, uploaded and called per step; the forward itself runs
    # in COMPUTE_TILE-wide tiles (pipeline/call_mods.py::forward_tiled)
    device_batch: int = 32768
    # host->device wire: "float16" halves upload bytes (the model upcasts
    # on the device); "float32" for exact-parity runs
    transfer_dtype: str = "float16"
    # accepted for JAX CLI compatibility: the float16 plane always ships
    # the read-packed wire (pipeline/call_mods.py says why)
    packed_wire: str = "auto"
    # parser threads; None = io.batching.default_parse_workers()
    num_parse_workers: int | None = None

    def __post_init__(self):
        if self.transfer_dtype not in ("float32", "float16"):
            raise ValueError("transfer_dtype must be float32|float16 "
                             "(int8 is not yet ported)")
        if self.packed_wire not in ("auto", "force", "off"):
            raise ValueError("packed_wire must be auto|force|off")
        if self.device_batch < 1:
            raise ValueError("device_batch must be >= 1")
        if self.num_parse_workers is not None and self.num_parse_workers < 1:
            raise ValueError("num_parse_workers must be >= 1")


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop settings (JAX config.py:133-150; reference train.py
    main args)."""
    batch_size: int = 512
    lr: float = 0.001
    lr_decay: float = 0.1
    lr_decay_step: int = 2
    max_epoch_num: int = 10
    min_epoch_num: int = 5
    step_interval: int = 100
    pos_weight: float = 1.0
    optim_type: str = "Adam"      # Adam | RMSprop | SGD | Ranger
    clip_grad: float = 0.5
    seed: int = 1234
    #: "auto": datasets that fit the device's budget are uploaded once and
    #: every step gathers its rows there; "never": host-fed steps
    device_resident: str = "auto"


def model_config_from_args(args, device, dropout_rate: float) -> ModelConfig:
    """ModelConfig from the model flags of call_mods and train (JAX
    config.py:153-172); each entry point passes its dropout rate."""
    from .utils.bases import str2bool
    from .utils.device import resolve_compute_dtype
    return ModelConfig(
        seq_len=args.seq_len, signal_len=args.signal_len,
        num_layers_comb=args.layernum1, num_layers_branch=args.layernum2,
        num_classes=args.class_num, dropout_rate=dropout_rate,
        hidden_size=args.hid_rnn, vocab_size=args.n_vocab,
        embedding_size=args.n_embed, is_base=str2bool(args.is_base),
        is_signallen=str2bool(args.is_signallen), module=args.model_type,
        compute_dtype=resolve_compute_dtype(args.compute_dtype, device),
        recurrence=resolve_recurrence(args.recurrence))
