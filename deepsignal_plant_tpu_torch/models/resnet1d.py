"""1-D ResNet signal encoder (counterpart of
deepsignal_plant_tpu/models/resnet1d.py).

The reference ships BasicBlock / ResNet_3layers / ResNet3
(deepsignal_plant/models.py:29-95) but leaves them disconnected (the
signal branch's conv stack is commented out, models.py:148,208-210). As
in the JAX package, no CLI path reaches this module: it is a tested
building block for a conv signal encoder.

The modules keep the reference's layout, so their ``state_dict`` is the
reference's: ``conv1``, ``bn1``, then ``layer<g>.0`` (one BasicBlock a
group, 16, 64 and ``out_channels`` planes) with ``conv1``, ``bn1``,
``conv2``, ``bn2`` and, where the stride or the width changes, the
``shortcut.0`` convolution and ``shortcut.1`` BatchNorm. Convolutions
have no bias; BatchNorm1d runs at eps 1e-5 and momentum 0.1, and in
training mode normalises with the batch statistics and moves the running
mean and the unbiased running variance, as JAX's ``batchnorm``.

The JAX package computes the convolutions with
``lax.conv_general_dilated`` outside any kernel; here they are
``nn.Conv1d`` (cuDNN on the card). cuDNN may run float32 convolutions in
TF32 (``torch.backends.cudnn.allow_tf32``, True by default in PyTorch);
the module leaves that setting to its caller.

Weights cross both ways: ``resnet3_from_params`` / ``resnet3_to_params``
with the JAX pytree (as numpy), and ``resnet3_from_state_dict`` reads a
reference ``state_dict`` (the counterpart of JAX's
``convert_torch_resnet3``).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Params = dict[str, Any]

BN_EPS, BN_MOMENTUM = 1e-5, 0.1
#: the planes of the first two groups (the third has ``out_channels``)
GROUP_PLANES = (16, 64)


def _bn(planes: int, device=None) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(planes, eps=BN_EPS, momentum=BN_MOMENTUM,
                          device=device)


class BasicBlock(nn.Module):
    """Residual block without pre-activation (reference BasicBlock,
    models.py:29-52)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.conv1 = nn.Conv1d(in_planes, planes, 3, stride, 1, bias=False,
                               device=device)
        self.bn1 = _bn(planes, device)
        self.conv2 = nn.Conv1d(planes, planes, 3, 1, 1, bias=False,
                               device=device)
        self.bn2 = _bn(planes, device)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv1d(in_planes, planes, 1, stride, bias=False,
                          device=device),
                _bn(planes, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class ResNet3(nn.Module):
    """A conv stem and three groups of one BasicBlock each (reference
    ResNet_3layers / ResNet3, models.py:55-95): (B, init_channels, L) ->
    (B, out_channels, get_lout(L, strides))."""

    def __init__(self, out_channels: int = 128, strides=(1, 2, 2),
                 init_channels: int = 1, in_planes: int = 4, device=None):
        super().__init__()
        self.strides = tuple(int(s) for s in strides)
        self.conv1 = nn.Conv1d(init_channels, in_planes, 3, 1, 1,
                               bias=False, device=device)
        self.bn1 = _bn(in_planes, device)
        cur = in_planes
        for gi, (planes, stride) in enumerate(zip(
                (*GROUP_PLANES, out_channels), self.strides)):
            setattr(self, f"layer{gi + 1}", nn.Sequential(
                BasicBlock(cur, planes, stride, device)))
            cur = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(out)))


def get_lout(lin: int, strides) -> int:
    """Output length after the strided convolutions (reference get_lout,
    models.py:85-90)."""
    lout = lin
    for s in strides:
        lout = math.floor(float(lout - 1) / s + 1)
    return lout


def _empty(out_channels: int, strides, init_channels: int, in_planes: int,
           device) -> ResNet3:
    """A ResNet3 with uninitialised storage on ``device`` (built on the
    meta device: torch's own init draws nothing from the global
    generator)."""
    return ResNet3(out_channels, strides, init_channels, in_planes,
                   device="meta").to_empty(device=device or "cpu")


def init_resnet3(generator: torch.Generator, out_channels: int = 128,
                 strides=(1, 2, 2), init_channels: int = 1,
                 in_planes: int = 4, device=None) -> ResNet3:
    """A fresh ResNet3: every convolution weight U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (torch Conv1d's default, kaiming-uniform at a =
    sqrt(5); JAX ``init_conv1d``), drawn in module order from the CPU
    ``generator``, so the weights do not depend on ``device``;
    BatchNorm scale 1, bias 0, running mean 0 and variance 1."""
    model = _empty(out_channels, strides, init_channels, in_planes, device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv1d):
                k = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0])
                w = torch.empty(m.weight.shape).uniform_(
                    -k, k, generator=generator)
                m.weight.copy_(w)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
    return model


_BN_FIELDS = (("scale", "weight"), ("bias", "bias"),
              ("mean", "running_mean"), ("var", "running_var"))


def params_to_state_dict(p: Params) -> dict[str, np.ndarray]:
    """The JAX pytree -> the reference ``state_dict`` names (numpy)."""
    sd: dict[str, np.ndarray] = {}

    def bn(prefix: str, b: Params) -> None:
        for ours, theirs in _BN_FIELDS:
            sd[f"{prefix}.{theirs}"] = np.asarray(b[ours], np.float32)

    sd["conv1.weight"] = np.asarray(p["conv1"]["w"], np.float32)
    bn("bn1", p["bn1"])
    for gi, blk in enumerate(p["layers"]):
        base = f"layer{gi + 1}.0"
        sd[f"{base}.conv1.weight"] = np.asarray(blk["conv1"]["w"],
                                                np.float32)
        bn(f"{base}.bn1", blk["bn1"])
        sd[f"{base}.conv2.weight"] = np.asarray(blk["conv2"]["w"],
                                                np.float32)
        bn(f"{base}.bn2", blk["bn2"])
        if "shortcut_conv" in blk:
            sd[f"{base}.shortcut.0.weight"] = np.asarray(
                blk["shortcut_conv"]["w"], np.float32)
            bn(f"{base}.shortcut.1", blk["shortcut_bn"])
    return sd


def state_dict_to_params(sd: dict, strides=(1, 2, 2)) -> Params:
    """A reference ``state_dict`` (tensors or arrays) -> the JAX pytree
    (numpy), the block strides given (the state holds none)."""
    def a(name: str) -> np.ndarray:
        t = sd[name]
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float32)

    def bn(prefix: str) -> Params:
        return {ours: a(f"{prefix}.{theirs}") for ours, theirs in _BN_FIELDS}

    p: Params = {"conv1": {"w": a("conv1.weight")}, "bn1": bn("bn1"),
                 "layers": []}
    for gi, stride in enumerate(strides):
        base = f"layer{gi + 1}.0"
        blk: Params = {"conv1": {"w": a(f"{base}.conv1.weight")},
                       "bn1": bn(f"{base}.bn1"),
                       "conv2": {"w": a(f"{base}.conv2.weight")},
                       "bn2": bn(f"{base}.bn2"), "stride": int(stride)}
        if f"{base}.shortcut.0.weight" in sd:
            blk["shortcut_conv"] = {"w": a(f"{base}.shortcut.0.weight")}
            blk["shortcut_bn"] = bn(f"{base}.shortcut.1")
        p["layers"].append(blk)
    return p


def _load(model: ResNet3, sd: dict) -> ResNet3:
    """Load ``sd`` (every parameter and running statistic; a missing
    ``num_batches_tracked`` counts from 0) into ``model``."""
    tensors = {k: v if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.array(v)) for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"not a ResNet3 of this layout: missing {missing}, "
                         f"unexpected {unexpected}")
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked") and name not in tensors:
            buf.zero_()
    return model


def _widths(sd: dict) -> tuple[int, int, int]:
    """(out_channels, init_channels, in_planes) of a ResNet3 state."""
    stem = sd["conv1.weight"]
    return (int(sd["layer3.0.conv2.weight"].shape[0]), int(stem.shape[1]),
            int(stem.shape[0]))


def resnet3_from_state_dict(sd: dict, strides=(1, 2, 2),
                            device=None) -> ResNet3:
    """A ResNet3 holding a reference ``state_dict`` (its widths read from
    the shapes; the strides, which the state does not hold, given:
    JAX's ``convert_torch_resnet3`` assumes the default (1, 2, 2))."""
    out_channels, init_channels, in_planes = _widths(sd)
    return _load(_empty(out_channels, strides, init_channels, in_planes,
                        device), sd)


def resnet3_from_params(p: Params, device=None) -> ResNet3:
    """A ResNet3 holding the JAX pytree ``p`` (numpy or JAX arrays; its
    blocks' ``stride`` entries give the strides)."""
    strides = tuple(int(np.asarray(blk["stride"])) for blk in p["layers"])
    return resnet3_from_state_dict(params_to_state_dict(p), strides, device)


def resnet3_to_params(model: ResNet3) -> Params:
    """The JAX pytree (numpy) of ``model``: parameters, running
    statistics and strides."""
    return state_dict_to_params(model.state_dict(), model.strides)
