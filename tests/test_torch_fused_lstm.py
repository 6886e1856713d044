"""The port's fused BiLSTM layer (deepsignal_plant_tpu_torch.ops.fused_lstm)
against the JAX package: its Pallas kernel in interpret mode and its
lax.scan layer. On the CPU the port's wrapper runs the kernel's plain
PyTorch version (ops/lstm.py), which is what these tests hold.

Inputs and weights are numpy arrays from a numpy seed, handed to both.
Tolerances: float32 1e-5 (the same math in other summation orders);
bfloat16 against the Pallas kernel 2e-2 — both keep products, gate math
and c in f32 and round h to bf16 every step, so they part only where a
sum lands on the other side of a bf16 rounding boundary (an ulp is 2^-8
just below 1), which later steps carry on. The JAX scan path is not a
bf16 reference: it rounds the input projection and bias to bf16
(deepsignal_plant_tpu/ops/lstm.py:113-116), the fused kernels do not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsignal_plant_tpu.ops.lstm import bilstm_layer as jax_scan_layer
from deepsignal_plant_tpu.ops.pallas_fused import \
    bilstm_layer_fused as jax_fused_layer
from deepsignal_plant_tpu_torch.models.bilstm import BiLSTMLayer
from deepsignal_plant_tpu_torch.ops import fused_lstm
from deepsignal_plant_tpu_torch.ops.fused_lstm import (bilstm_layer_fused,
                                                       bilstm_stack_fused_tm)

# (B, T, input widths, H, seq_out): the three shapes of
# tests/test_pallas_fused.py, final states only, and row-split inputs
CASES = {
    "tiny_unaligned_B": (4, 13, (16,), 8, True),
    "seq_branch_odd_F": (16, 13, (7,), 32, True),
    "short_T": (8, 5, (24,), 16, True),
    "final_states": (6, 13, (16,), 8, False),
    "row_split": (4, 9, (8, 24), 16, True),
    "row_split_final": (5, 13, (16, 16), 8, False),
}
F32_TOL = 1e-5
BF16_TOL = 2e-2


def make_layer(seed, B, T, Fs, H):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    xs = [rng.normal(size=(T, B, F)).astype(np.float32) for F in Fs]
    p = {"w_ih": rng.uniform(-k, k, (2, sum(Fs), 4 * H)).astype(np.float32),
         "w_hh": rng.uniform(-k, k, (2, H, 4 * H)).astype(np.float32),
         "b": (rng.uniform(-k, k, (2, 4 * H))
               + rng.uniform(-k, k, (2, 4 * H))).astype(np.float32)}
    return xs, p


def port_layer(xs, p, H, seq_out, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    ys = bilstm_layer_fused(tuple(torch.from_numpy(x).to(dtype) for x in xs),
                            t["w_ih"].to(dtype), t["b"], t["w_hh"].to(dtype),
                            H, seq_out)
    return [y.float().numpy() for y in ys]


def jax_fused(xs, p, H, seq_out, dtype=jnp.float32):
    ys = jax_fused_layer(tuple(jnp.asarray(x, dtype) for x in xs),
                         jnp.asarray(p["w_ih"], dtype), jnp.asarray(p["b"]),
                         jnp.asarray(p["w_hh"], dtype), H, seq_out=seq_out,
                         block_b=8, interpret=True)
    return [np.asarray(y, np.float32) for y in ys]


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_jax_fused_kernel(case):
    B, T, Fs, H, seq_out = CASES[case]
    xs, p = make_layer(1, B, T, Fs, H)
    got = port_layer(xs, p, H, seq_out)
    want = jax_fused(xs, p, H, seq_out)
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((T if seq_out else 1), B, H)
        np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_jax_scan(case):
    B, T, Fs, H, seq_out = CASES[case]
    xs, p = make_layer(2, B, T, Fs, H)
    ys_f, ys_b = port_layer(xs, p, H, seq_out)
    x_bm = np.concatenate([np.moveaxis(x, 0, 1) for x in xs], axis=-1)
    want = np.asarray(jax_scan_layer(jnp.asarray(x_bm),
                                     {k: jnp.asarray(v) for k, v in p.items()},
                                     H, impl="scan", return_sequence=seq_out))
    if seq_out:
        got = np.concatenate([np.moveaxis(ys_f, 0, 1),
                              np.moveaxis(ys_b, 0, 1)], axis=-1)
    else:
        got = np.concatenate([ys_f[0], ys_b[0]], axis=-1)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("case", ["seq_branch_odd_F", "row_split_final"])
def test_layer_bf16_matches_jax_fused_kernel(case):
    B, T, Fs, H, seq_out = CASES[case]
    xs, p = make_layer(3, B, T, Fs, H)
    got = port_layer(xs, p, H, seq_out, torch.bfloat16)
    want = jax_fused(xs, p, H, seq_out, jnp.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=BF16_TOL, rtol=0)


def test_stack_matches_jax_fused_stack():
    """Three layers threading (fwd, bwd) halves, top layer final states
    only: the port's stack against the JAX fused stack."""
    from deepsignal_plant_tpu.ops.pallas_fused import \
        bilstm_stack_fused_tm as jax_stack
    B, T, F, H = 6, 13, 16, 8
    rng = np.random.default_rng(4)
    x = rng.normal(size=(T, B, F)).astype(np.float32)
    params = [make_layer(10 + i, B, T, (F if i == 0 else 2 * H,), H)[1]
              for i in range(3)]
    layers = []
    for p in params:
        m = BiLSTMLayer(p["w_ih"].shape[1], H)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
        layers.append(m)
    with torch.no_grad():
        got = bilstm_stack_fused_tm(torch.from_numpy(x), layers, H,
                                    last_layer_sequence=False)
    want = jax_stack(jnp.asarray(x), [{k: jnp.asarray(v) for k, v in
                                       p.items()} for p in params], H,
                     last_layer_sequence=False, block_b=8, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=0)


def test_cpu_path_launches_no_kernel():
    """The launch count moves only where the CUDA kernel launches."""
    xs, p = make_layer(5, 4, 13, (16,), 8)
    before = fused_lstm.launches
    port_layer(xs, p, 8, True)
    assert fused_lstm.launches == before


def test_layer_rejects_mismatched_inputs():
    xs, p = make_layer(6, 4, 13, (16,), 8)
    with pytest.raises(ValueError):      # w_ih has 16 rows, inputs 32
        port_layer(xs + xs, p, 8, True)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
