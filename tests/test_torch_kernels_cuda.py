"""The fused BiLSTM layer kernel (csrc/fused_bilstm.cu) against its plain
PyTorch version on the card, at the main path's layer shapes.

Marked ``cuda``: each test skips without a card. On a machine with one
(which need not have JAX), run them alone:

    python -m pytest -m cuda --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

Tolerances. float32: 2e-5 absolute on outputs in (-1, 1) — the kernel
and the plain version sum up to 768 products per gate in different
orders, and the difference compounds over 13 steps. bfloat16: 2e-2 —
both round h to bf16 (8 significant bits, an ulp of 2^-8 just below 1)
after every step, so a sum that lands on the other side of a rounding
boundary moves one h by an ulp, which the following steps carry on.
"""
import numpy as np
import pytest
import torch

from deepsignal_plant_tpu_torch.ops import fused_lstm
from deepsignal_plant_tpu_torch.ops.lstm import bilstm_layer

pytestmark = pytest.mark.cuda

T = 13
# (Fa, Fb, H, seq_out) of the five layer launches of one forward tile
MAIN_PATH_LAYERS = {
    "seq": (7, 0, 128, True),
    "signal": (16, 0, 128, True),
    "comb0": (128, 128, 256, True),
    "comb1": (256, 256, 256, True),
    "comb2": (256, 256, 256, False),
}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def layer_inputs(Fa, Fb, H, B, dtype, device, seed=0):
    """Seeded inputs: x ~ N(0,1) for the branch layers (raw features),
    U(-1,1) for the comb layers (previous layers' h); torch's LSTM init
    U(-1/sqrt(H), 1/sqrt(H)) for the weights, a sum of two for the bias."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    xs = [rng.normal(size=(T, B, F)) if Fb == 0 else
          rng.uniform(-1, 1, (T, B, F)) for F in ((Fa, Fb) if Fb else (Fa,))]
    w_ih = rng.uniform(-k, k, (2, Fa + Fb, 4 * H))
    w_hh = rng.uniform(-k, k, (2, H, 4 * H))
    b = rng.uniform(-k, k, (2, 4 * H)) + rng.uniform(-k, k, (2, 4 * H))

    def dev(a, dt):
        return torch.tensor(a, dtype=torch.float32).to(device, dt)

    return (tuple(dev(x, dtype) for x in xs), dev(w_ih, dtype),
            dev(b, torch.float32), dev(w_hh, dtype))


# widths the main path does not use, for the kernels' edges: H not a
# multiple of 8, odd and row-split F, fewer rows than one block
ODD_LAYERS = {
    "odd_H": (7, 0, 20, True),
    "odd_split": (5, 3, 12, False),
    "narrow": (16, 0, 8, True),
    "wide_split": (24, 40, 96, True),
}


def check_against_plain(Fa, Fb, H, seq_out, B, dtype, device):
    xs, w_ih, b, w_hh = layer_inputs(Fa, Fb, H, B, dtype, device)
    before = fused_lstm.launches
    got = fused_lstm.bilstm_layer_fused(xs, w_ih, b, w_hh, H, seq_out)
    torch.cuda.synchronize()
    assert fused_lstm.launches == before + 1
    want = bilstm_layer(xs, w_ih, b, w_hh, H, seq_out)
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((T if seq_out else 1), B, H)
        assert g.dtype == dtype
        err = (g.float() - w.float()).abs().max().item()
        assert err <= TOL[dtype], f"F=({Fa},{Fb}) H={H} B={B} {dtype}: {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [4096, 4093])
@pytest.mark.parametrize("layer", list(MAIN_PATH_LAYERS))
def test_kernel_matches_plain(device, layer, B, dtype):
    check_against_plain(*MAIN_PATH_LAYERS[layer], B, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("layer", list(ODD_LAYERS))
def test_kernel_matches_plain_at_odd_widths(device, layer, B, dtype):
    check_against_plain(*ODD_LAYERS[layer], B, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_reads_inputs_off_16_byte_alignment(device, dtype):
    xs, w_ih, b, w_hh = layer_inputs(128, 128, 256, 37, dtype, device)
    # contiguous views one element into a larger buffer
    shifted = []
    for x in xs:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        shifted.append(view)
    got = fused_lstm.bilstm_layer_fused(tuple(shifted), w_ih, b, w_hh, 256)
    want = bilstm_layer(xs, w_ih, b, w_hh, 256, True)
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]


def test_kernel_rejects_what_it_does_not_take(device):
    xs, w_ih, b, w_hh = layer_inputs(16, 0, 128, 64, torch.float32, device)
    with pytest.raises(ValueError):        # bias must be float32
        fused_lstm.bilstm_layer_fused(xs, w_ih, b.double(), w_hh, 128)
    with pytest.raises(TypeError):         # float16 is not a storage type
        fused_lstm.bilstm_layer_fused(tuple(x.half() for x in xs),
                                      w_ih.half(), b, w_hh.half(), 128)
    with pytest.raises(ValueError):        # non-contiguous input
        fused_lstm.bilstm_layer_fused(
            (xs[0].transpose(0, 1).contiguous().transpose(0, 1),),
            w_ih, b, w_hh, 128)
