"""The port's ModelBiLSTM and checkpoint I/O against the JAX package.

The JAX parameter pytree goes through params_from_numpy; the port's
float32 logits must be within 2e-5 of JAX ``forward(recurrence="scan")``
on the same numpy inputs (the same math in other summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsignal_plant_tpu.config import ModelConfig as JaxModelConfig
from deepsignal_plant_tpu.models import bilstm as jax_bilstm
from deepsignal_plant_tpu.models import convert as jax_convert
from deepsignal_plant_tpu_torch.config import ModelConfig
from deepsignal_plant_tpu_torch.models import convert
from deepsignal_plant_tpu_torch.models.bilstm import (Batch, ModelBiLSTM,
                                                      forward_flops_per_site,
                                                      init_params)

MODULES = ["both_bilstm", "seq_bilstm", "signal_bilstm"]
NARROW = dict(hidden_size=32, num_layers_comb=2, dropout_rate=0.0)
LOGIT_TOL = 2e-5


def numpy_batch(n=37, seed=0, L=13, S=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, (n, L)).astype(np.int32),
            rng.normal(size=(n, L)).astype(np.float32),
            np.abs(rng.normal(size=(n, L))).astype(np.float32),
            rng.integers(1, 30, (n, L)).astype(np.float32),
            rng.normal(size=(n, L, S)).astype(np.float32))


def jax_params(cfg):
    p = jax_bilstm.init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(np.asarray, p), p


def port_logits(params, cfg, arrays):
    model = ModelBiLSTM.from_params(params, cfg, torch.device("cpu"))
    with torch.inference_mode():
        logits, probs = model(Batch(*map(torch.from_numpy, arrays)))
    return logits.numpy(), probs.numpy(), model


@pytest.mark.parametrize("module", MODULES)
def test_logits_match_jax_scan(module):
    jcfg = JaxModelConfig(module=module, **NARROW)
    np_params, p = jax_params(jcfg)
    arrays = numpy_batch()
    want, want_p = jax_bilstm.forward(p, jax_bilstm.Batch(
        *map(jnp.asarray, arrays)), jcfg)
    got, got_p, _ = port_logits(np_params, ModelConfig(module=module,
                                                       **NARROW), arrays)
    assert got.dtype == np.float32 and got.shape == (37, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(got_p, np.asarray(want_p), atol=LOGIT_TOL,
                               rtol=0)


@pytest.mark.parametrize("module", MODULES)
def test_parameter_counts_match(module):
    jcfg = JaxModelConfig(module=module, **NARROW)
    np_params, _ = jax_params(jcfg)
    model = ModelBiLSTM(ModelConfig(module=module, **NARROW))
    assert sum(t.numel() for t in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(np_params))
    full = ModelBiLSTM(ModelConfig(module=module), device="meta")
    assert sum(t.numel() for t in full.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(jax.eval_shape(
            lambda: jax_bilstm.init_params(jax.random.PRNGKey(0),
                                           JaxModelConfig(module=module)))))


@pytest.mark.parametrize("module", MODULES)
def test_flops_per_site_match(module):
    assert forward_flops_per_site(ModelConfig(module=module)) == \
        jax_bilstm.forward_flops_per_site(JaxModelConfig(module=module))


def test_jax_npz_checkpoint_loads_in_port(tmp_path):
    """A JAX checkpoint whose embedded config says recurrence="pallas"
    loads with the port's "kernel" and gives the same logits."""
    jcfg = JaxModelConfig(recurrence="pallas", **NARROW)
    np_params, p = jax_params(jcfg)
    path = str(tmp_path / "m.ckpt.npz")
    jax_convert.save_checkpoint(path, p, jcfg)
    params, cfg = convert.load_checkpoint(path)
    assert cfg == ModelConfig(recurrence="kernel", **NARROW)
    arrays = numpy_batch(seed=1)
    a, _, _ = port_logits(params, cfg, arrays)
    b, _, _ = port_logits(np_params, cfg, arrays)
    np.testing.assert_array_equal(a, b)


def test_port_npz_checkpoint_loads_in_jax(tmp_path):
    cfg = ModelConfig(module="seq_bilstm", **NARROW)
    params = init_params(cfg, seed=3)
    path = str(tmp_path / "port.ckpt.npz")
    convert.save_checkpoint(path, params, cfg)
    jparams, jcfg = jax_convert.load_checkpoint(path)
    assert jcfg == JaxModelConfig(module="seq_bilstm", recurrence="pallas",
                                  **NARROW)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_reference_torch_checkpoint_loads(tmp_path):
    """A reference-layout torch state_dict (weights_only load, strict
    key audit) converts to the JAX converter's pytree."""
    jcfg = JaxModelConfig(**NARROW)
    np_params, _ = jax_params(jcfg)
    sd = jax_convert.params_to_torch_state_dict(np_params, jcfg)
    path = str(tmp_path / "ref.ckpt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got = convert.load_any_checkpoint(path, ModelConfig(**NARROW))
    want = jax_convert.load_any_checkpoint(path, jcfg)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)
    del sd["fc2.bias"]
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    with pytest.raises(ValueError, match="missing keys"):
        convert.load_any_checkpoint(path, ModelConfig(**NARROW))


def test_params_from_numpy_rejects_a_wrong_config():
    np_params, _ = jax_params(JaxModelConfig(**NARROW))
    with pytest.raises(ValueError, match="misshapen"):
        convert.params_from_numpy(np_params, ModelConfig(
            hidden_size=16, num_layers_comb=2))
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy(np_params, ModelConfig(
            hidden_size=32, num_layers_comb=3))


def test_scan_and_kernel_recurrences_agree_on_cpu():
    """On CPU tensors the kernel wrapper runs the plain version, so both
    recurrences give the same logits."""
    cfg = ModelConfig(**NARROW)
    params = init_params(cfg, seed=5)
    arrays = numpy_batch(seed=2)
    a, _, _ = port_logits(params, cfg.with_(recurrence="kernel"), arrays)
    b, _, _ = port_logits(params, cfg.with_(recurrence="scan"), arrays)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("module", MODULES)
def test_bf16_logits_match_jax_fused_path(module, monkeypatch):
    """bfloat16: the port's forward has the JAX package's fused-path
    structure (_forward_fused_tm), so its logits follow JAX
    ``recurrence="pallas"`` with the Pallas kernels in interpret mode.
    Tolerance 2^-7, one bf16 ulp at |logit| in [1, 2): both round the same
    bf16 operations, and only a summation order inside an f32
    accumulation can move a rounding."""
    from deepsignal_plant_tpu.ops import pallas_fused
    monkeypatch.setattr(pallas_fused, "_INTERPRET", True)
    jcfg = JaxModelConfig(module=module, recurrence="pallas",
                          compute_dtype="bfloat16", **NARROW)
    np_params, p = jax_params(jcfg)
    arrays = numpy_batch(seed=3)
    want, _ = jax_bilstm.forward(p, jax_bilstm.Batch(
        *map(jnp.asarray, arrays)), jcfg)
    got, _, _ = port_logits(np_params, ModelConfig(
        module=module, compute_dtype="bfloat16", **NARROW), arrays)
    np.testing.assert_allclose(got, np.asarray(want), atol=2 ** -7, rtol=0)
