"""The port's ResNet1d (models/resnet1d.py) against the JAX package's, on
the CPU: the same parameters carried across (JAX's initialisation into
the port's modules, the port's back into JAX's pytree), the forward in
eval and in training mode within 2e-5 (outputs and the running
statistics training mode moves), JAX's ``convert_torch_resnet3`` reading
the port's ``state_dict``, and the initialisation."""
import math

import jax
import numpy as np
import pytest
import torch

from deepsignal_plant_tpu.models import resnet1d as jax_resnet
from deepsignal_plant_tpu_torch.models import resnet1d

TOL = 2e-5
#: (out_channels, strides, in_planes, batch, length)
SHAPES = [(32, (1, 2, 2), 4, 4, 16), (16, (2, 1, 2), 4, 8, 13),
          (64, (1, 1, 1), 8, 3, 21)]


def numpy_tree(tree):
    """A JAX ResNet3 pytree as numpy (strides stay ints)."""
    return jax.tree_util.tree_map(
        lambda v: v if isinstance(v, int) else np.asarray(v), tree)


def jax_params(out_channels, strides, in_planes, seed=0):
    return numpy_tree(jax_resnet.init_resnet3(
        jax.random.PRNGKey(seed), out_channels, strides, 1, in_planes))


def flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def assert_trees_close(got, want, tol):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("strides", [(1, 2, 2), (1, 1, 1), (2, 2, 2),
                                     (2, 1, 2)])
@pytest.mark.parametrize("lin", [13, 16, 100, 1])
def test_get_lout_matches_jax(lin, strides):
    assert resnet1d.get_lout(lin, strides) == jax_resnet.get_lout(lin,
                                                                  strides)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"c{s[0]}")
def test_forward_matches_jax(shape, train):
    out_channels, strides, in_planes, batch, length = shape
    params = jax_params(out_channels, strides, in_planes)
    if not train:       # eval mode normalises with non-trivial statistics
        params = numpy_tree(jax_resnet.resnet3(
            np.random.default_rng(1).normal(
                size=(16, 1, length)).astype(np.float32) * 3 + 1,
            params, train=True)[1])
    x = np.random.default_rng(2).normal(
        size=(batch, 1, length)).astype(np.float32)
    want, want_params = jax_resnet.resnet3(x, params, train=train)
    model = resnet1d.resnet3_from_params(params)
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, out_channels,
                         resnet1d.get_lout(length, strides))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    assert_trees_close(resnet1d.resnet3_to_params(model),
                       numpy_tree(want_params), TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_jax_converter_reads_the_ports_state_dict(train):
    """JAX's convert_torch_resnet3 on the port's state_dict (the
    reference layout, default strides) gives the port's outputs."""
    model = resnet1d.init_resnet3(torch.Generator().manual_seed(3), 32)
    x = np.random.default_rng(4).normal(size=(6, 1, 16)).astype(np.float32)
    with torch.no_grad():
        model.train(True)
        model(torch.from_numpy(x * 2 - 1))  # move the running statistics
    params = jax_resnet.convert_torch_resnet3(model.state_dict())
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want, _ = jax_resnet.resnet3(x, params, train=train)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"c{s[0]}")
def test_parameters_round_trip(shape):
    """JAX pytree -> module -> pytree is the identity, and module ->
    pytree -> module and module -> state_dict -> module keep every
    tensor."""
    out_channels, strides, in_planes, _, _ = shape
    params = jax_params(out_channels, strides, in_planes, seed=5)
    back = resnet1d.resnet3_to_params(resnet1d.resnet3_from_params(params))
    assert_trees_close(back, params, 0.0)
    assert [b["stride"] for b in back["layers"]] == list(strides)
    model = resnet1d.init_resnet3(torch.Generator().manual_seed(6),
                                  out_channels, strides, 1, in_planes)
    for again in (resnet1d.resnet3_from_params(
            resnet1d.resnet3_to_params(model)),
            resnet1d.resnet3_from_state_dict(model.state_dict(), strides)):
        sd, sd2 = model.state_dict(), again.state_dict()
        assert list(sd) == list(sd2)
        for k in sd:
            assert torch.equal(sd[k], sd2[k]), k


def test_layout_is_the_references():
    """The reference's state_dict keys: shortcuts where the stride or the
    width changes (every group from a 4-plane stem), none elsewhere."""
    keys = set(resnet1d.ResNet3(128).state_dict())
    for g in (1, 2, 3):
        assert f"layer{g}.0.shortcut.0.weight" in keys
        assert f"layer{g}.0.shortcut.1.running_var" in keys
    assert "layer1.0.conv1.weight" in keys and "bn1.running_mean" in keys
    same = resnet1d.BasicBlock(16, 16, 1)
    assert not any(k.startswith("shortcut") for k in same.state_dict())
    m = resnet1d.ResNet3(128)
    assert (m.layer2[0].conv1.stride, m.layer3[0].shortcut[0].stride,
            m.bn1.eps, m.bn1.momentum) == ((2,), (2,), 1e-5, 0.1)
    assert all(c.bias is None for c in m.modules()
               if isinstance(c, torch.nn.Conv1d))


def test_init_resnet3():
    """Weights in +-1/sqrt(fan_in), the same from the same generator on
    every call, BatchNorm at its identity; the global generator
    untouched."""
    state = torch.random.get_rng_state()
    a = resnet1d.init_resnet3(torch.Generator().manual_seed(7), 64)
    assert torch.equal(torch.random.get_rng_state(), state)
    b = resnet1d.init_resnet3(torch.Generator().manual_seed(7), 64)
    c = resnet1d.init_resnet3(torch.Generator().manual_seed(8), 64)
    for (name, wa), wb, wc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(wa, wb), name
        if name.endswith(".weight") and wa.dim() == 3:
            bound = 1 / math.sqrt(wa.shape[1] * wa.shape[2])
            assert wa.abs().max() <= bound and wa.abs().max() > bound / 2
            assert not torch.equal(wa, wc), name
    for m in a.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))
            assert torch.equal(m.running_mean, torch.zeros_like(m.bias))
            assert torch.equal(m.running_var, torch.ones_like(m.bias))


def test_a_foreign_state_dict_is_refused():
    sd = resnet1d.ResNet3(32).state_dict()
    sd.pop("layer2.0.bn2.running_var")
    with pytest.raises(ValueError, match="missing"):
        resnet1d.resnet3_from_state_dict(sd)
