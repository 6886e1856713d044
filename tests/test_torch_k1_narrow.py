"""K1's float32 narrow kernel in the port (deepsignal_plant_tpu_torch.ops
.fused_lstm, csrc/fused_bilstm.cu's fused_bilstm_narrow_f32_kernel): the
layers whose input is narrower than the projection's K slab of 32 (the
seq and signal branches), one launch a layer, 3xTF32 products over
[W_ih; W_hh] slices resident across a thread-block cluster.

The kernel runs only on the card. Here: its plan (narrow_plan, narrow_smem)
on the H100's capacities, the weight packing as the kernel's blocks read
it, the three-route rule's choice at the main path's shapes, and a plain
emulation of the kernel's arithmetic (emulate_narrow: the packed slices
read as the blocks read them, each f32 operand split into tf32 hi and lo
by fused_lstm.tf32_split, lo*lo dropped, the projection inside the
step) held against the JAX package's fused Pallas kernel in interpret
mode, with numpy inputs from a seed handed to both. Tolerance 2e-5 (as
tests/test_torch_k1_f32.py): the same f32 math in another order of
additions over 13 steps, and the dropped lo*lo terms (2^-22 of a
product).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsignal_plant_tpu.ops.pallas_fused import \
    bilstm_layer_fused as jax_fused_layer
from deepsignal_plant_tpu_torch.models.bilstm import BiLSTMLayer
from deepsignal_plant_tpu_torch.ops import fused_lstm
from deepsignal_plant_tpu_torch.ops import lstm as plain

T = 13
TOL = 2e-5
SMEM = 232_448
H100_SMS = 132
# the H100's capacities of the narrow kernel's plans, as its occupancy
# query reported them: one block an SM at every row tile (PERF.md)
H100_CLUSTERS = {2: 66, 8: 15}
# (F, H) of the layers the main paths give the narrow kernel: the seq and
# signal branches of both_bilstm, and denoise's signal_bilstm first layer
MAIN_NARROW = {"seq": (7, 128), "signal": (16, 128)}
DENOISE_NARROW = (16, 256)
# call_mods' tiles (full, ragged, tail), train's evaluation tile and a
# two-rank share of it
MAIN_B = (4096, 4093, 1016, 512, 256)
DENOISE_B = (512, 509, 93, 256)


def h100_capacity(C, rows):
    return H100_CLUSTERS[C]


def make_layer(seed, Fs, H, B=37):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    xs = [rng.normal(size=(T, B, F)).astype(np.float32) for F in Fs]
    p = {"w_ih": rng.uniform(-k, k, (2, sum(Fs), 4 * H)).astype(np.float32),
         "w_hh": rng.uniform(-k, k, (2, H, 4 * H)).astype(np.float32),
         "b": (rng.uniform(-k, k, (2, 4 * H))
               + rng.uniform(-k, k, (2, 4 * H))).astype(np.float32)}
    return xs, p


def block_weights(packed, H, cluster):
    """[W_ih (padded to Kx); W_hh] (2, K, 4H), gate-major columns (g * H +
    unit), read from the packed weights as the kernel's blocks read them:
    block r copies rows [4U r, 4U (r + 1)) (K-major), its row n holding
    gate n // 8 % 4 of its unit 8 (n // 32) + n % 8."""
    K = packed.shape[2]
    U = H // cluster
    W = torch.zeros(2, K, 4, H)
    for r in range(cluster):
        sl = packed[:, r * 4 * U:(r + 1) * 4 * U]            # (2, 4U, K)
        sl = sl.reshape(2, U // 8, 4, 8, K).permute(0, 4, 2, 1, 3)
        W[:, :, :, r * U:(r + 1) * U] = sl.reshape(2, K, 4, U)
    return W.reshape(2, K, 4 * H)


def emulate_narrow(xs, packed, b, H, seq_out, cluster):
    """The narrow kernel's arithmetic on the CPU: per step and direction
    pre = b + [x_t | 0 | h_{t-1}] @ W in 3xTF32 (lo*hi + hi*lo + hi*hi,
    each operand split by fused_lstm.tf32_split, lo*lo dropped), the gates
    i, f, g, o, c and h in f32; direction 1 reads x at T-1-s and its
    states come out in true time."""
    T_, B = xs[0].shape[:2]
    F = sum(x.shape[-1] for x in xs)
    Kx = fused_lstm.narrow_kx(F)
    W = block_weights(packed, H, cluster)
    w_hi, w_lo = fused_lstm.tf32_split(W)
    x = torch.cat(xs, dim=-1)
    h = torch.zeros(2, B, H)
    c = torch.zeros(2, B, H)
    ys = []
    for s in range(T_):
        xt = torch.stack([x[s], x[T_ - 1 - s]])              # (2, B, F)
        a = torch.cat([xt, torch.zeros(2, B, Kx - F), h], dim=-1)
        a_hi, a_lo = fused_lstm.tf32_split(a)
        pre = b[:, None, :] + (torch.bmm(a_lo, w_hi) + torch.bmm(a_hi, w_lo)
                               + torch.bmm(a_hi, w_hi))
        i, f, g, o = pre.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    ys = torch.stack(ys)                                     # (T, 2, B, H)
    return plain.k1_outputs(ys, seq_out)


def tensors(xs, p):
    return (tuple(torch.from_numpy(x) for x in xs),
            *(torch.from_numpy(p[k]) for k in ("w_ih", "b", "w_hh")))


@pytest.mark.parametrize("seq_out", [True, False])
@pytest.mark.parametrize("Fs", [(7,), (16,), (8, 8)],
                         ids=["seq_F7", "signal_F16", "split_8_8"])
def test_emulation_matches_jax_fused_kernel(Fs, seq_out):
    """The narrow kernel's arithmetic (emulate_narrow over
    pack_narrow_weights at H = 128, clusters of 2) against JAX
    bilstm_layer_fused in interpret mode at float32, and against the
    port's plain version (ops/lstm.py::bilstm_layer)."""
    H = 128
    xs, p = make_layer(21, Fs, H)
    tx, w_ih, b, w_hh = tensors(xs, p)
    packed = fused_lstm.pack_narrow_weights(w_ih, w_hh)
    got = emulate_narrow(tx, packed, b, H, seq_out,
                         H // fused_lstm.NARROW_UNITS[H])
    want = jax_fused_layer(tuple(jnp.asarray(x) for x in xs),
                           jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
                           jnp.asarray(p["w_hh"]), H, seq_out=seq_out,
                           block_b=8, interpret=True)
    ref = plain.bilstm_layer(tx, w_ih, b, w_hh, H, seq_out)
    for g, w, r in zip(got, want, ref):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape == ((T if seq_out else 1), 37, H)
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("seq_out", [True, False])
def test_emulation_at_denoise_width_matches_plain(seq_out):
    """At H = 256 (denoise's signal_bilstm first layer, clusters of 8
    blocks of 32 units) the emulation over the packed slices against the
    plain version."""
    H = 256
    xs, p = make_layer(22, (16,), H, B=19)
    tx, w_ih, b, w_hh = tensors(xs, p)
    packed = fused_lstm.pack_narrow_weights(w_ih, w_hh)
    got = emulate_narrow(tx, packed, b, H, seq_out, 8)
    for g, w in zip(got, plain.bilstm_layer(tx, w_ih, b, w_hh, H, seq_out)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("F,H", [(7, 128), (16, 128), (16, 256), (5, 8),
                                 (12, 24)])
def test_packing_lays_out_the_weights(F, H):
    """pack_narrow_weights: (2, 4H, Kx + H) float32, K-major, Kx = F
    rounded up to 8 or 16; row 32 grp + 8 gate + e is gate ``gate`` of
    unit 8 grp + e; its columns W_ih's rows, zeros to Kx, then W_hh's:
    regrouped it is [W_ih; 0; W_hh] exactly, whatever the cluster that
    reads it."""
    _, p = make_layer(23, (F,), H, B=2)
    w_ih, w_hh = torch.from_numpy(p["w_ih"]), torch.from_numpy(p["w_hh"])
    packed = fused_lstm.pack_narrow_weights(w_ih, w_hh)
    Kx = fused_lstm.narrow_kx(F)
    assert Kx in (8, 16) and Kx - 8 < F <= Kx
    assert packed.shape == (2, 4 * H, Kx + H)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    want = torch.cat([w_ih, torch.zeros(2, Kx - F, 4 * H), w_hh], dim=1)
    clusters = [1] + ([H // fused_lstm.NARROW_UNITS[H]]
                      if H in fused_lstm.NARROW_UNITS else [])
    for cluster in clusters:
        assert torch.equal(block_weights(packed, H, cluster), want)
    # row 8 of a group is gate f of its first unit
    torch.testing.assert_close(packed[:, 8, Kx:], w_hh[:, :, H],
                               rtol=0, atol=0)


def test_packed_narrow_weights_cached_until_a_weight_changes():
    """packed_narrow_weights packs once per model: the same tensor until
    an in-place update of w_ih or w_hh (an optimizer step) or a new
    parameter; the bias is read as it is."""
    _, p = make_layer(24, (16,), 16, B=2)
    layer = BiLSTMLayer(16, 16)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    first = fused_lstm.packed_narrow_weights(layer)
    assert fused_lstm.packed_narrow_weights(layer) is first
    with torch.no_grad():
        layer.b.add_(1.0)
    assert fused_lstm.packed_narrow_weights(layer) is first
    with torch.no_grad():
        layer.w_hh.mul_(2.0)
    second = fused_lstm.packed_narrow_weights(layer)
    assert second is not first
    torch.testing.assert_close(second[:, :, 16:], first[:, :, 16:] * 2.0)
    with torch.no_grad():
        layer.w_ih.add_(1.0)
    third = fused_lstm.packed_narrow_weights(layer)
    assert third is not second
    layer.w_hh = torch.nn.Parameter(layer.w_hh.detach().clone())
    assert fused_lstm.packed_narrow_weights(layer) is not third


@pytest.mark.parametrize("rows", fused_lstm.NARROW_ROWS)
@pytest.mark.parametrize("F,H", [(7, 128), (16, 128), (8, 256), (16, 256),
                                 (12, 128)])
def test_smem_counts_the_slice_and_the_a_buffer(F, H, rows):
    """narrow_smem: the 4U rows of the transposed slice and ``rows`` rows
    of A, each Kx + H + 4 floats; at the main path's 128-row tile
    (signal, F = 16, H = 128) 151,552 + 75,776 = 227,328 bytes of the
    232,448 a block has."""
    Kx = fused_lstm.narrow_kx(F)
    U = fused_lstm.NARROW_UNITS[H]
    assert fused_lstm.narrow_smem(F, H, rows) == \
        4 * (Kx + H + 4) * 4 * U + 4 * rows * (Kx + H + 4)
    if (F, H, rows) == (16, 128, 128):
        assert fused_lstm.narrow_smem(F, H, rows) == 227_328 <= SMEM


@pytest.mark.parametrize("B", MAIN_B)
@pytest.mark.parametrize("layer", list(MAIN_NARROW))
def test_plan_covers_the_main_path(layer, B):
    """narrow_plan on the H100's capacities at the branches' shapes:
    clusters of 2 blocks of 64 units, a row tile within a block's shared
    memory, tiles that cover the B rows once; at 4,096 rows 128-row tiles
    in one wave (64 clusters, 128 blocks on 132 SMs)."""
    F, H = MAIN_NARROW[layer]
    plan = fused_lstm.narrow_plan(F, H, B, h100_capacity)
    assert plan is not None
    C, rows = plan
    assert C == 2 and C * fused_lstm.NARROW_UNITS[H] == H
    assert rows in fused_lstm.NARROW_ROWS
    assert fused_lstm.narrow_smem(F, H, rows) <= SMEM
    tiles = -(-B // rows)
    assert tiles * rows >= B > (tiles - 1) * rows
    if B in (4096, 4093):
        assert rows == 128
        assert 2 * tiles <= H100_CLUSTERS[C]
        assert 2 * tiles * C <= H100_SMS


@pytest.mark.parametrize("B", DENOISE_B)
def test_plan_covers_denoise_signal_layer(B):
    """denoise's signal_bilstm first layer (F = 16, H = 256): clusters of
    8 blocks of 32 units, one wave at --batch_size 512 (80-row tiles, 14
    clusters of the 15 the H100 holds)."""
    F, H = DENOISE_NARROW
    C, rows = fused_lstm.narrow_plan(F, H, B, h100_capacity)
    assert C == 8 and fused_lstm.narrow_smem(F, H, rows) <= SMEM
    tiles = -(-B // rows)
    assert tiles * rows >= B > (tiles - 1) * rows
    assert 2 * tiles <= H100_CLUSTERS[C]
    if B in (512, 509):
        assert rows == 80


@pytest.mark.parametrize("F,H", [(256, 256), (512, 256), (128, 256),
                                 (32, 128), (17, 128), (31, 256), (16, 96),
                                 (7, 64), (16, 512), (0, 128)])
def test_no_plan_off_the_narrow_shapes(F, H):
    """No plan for the comb layers (F >= 32: the projection kernel's
    inputs), for inputs wider than the kernel's 16 x columns, nor for H
    other than 128 and 256."""
    assert fused_lstm.narrow_plan(F, H, 4096, h100_capacity) is None


def test_plan_skips_tiles_the_card_cannot_hold():
    """A row tile the card holds no cluster of is never planned; with no
    such tile at all there is no plan."""
    plan = fused_lstm.narrow_plan(16, 128, 4096,
                                  lambda C, rows: 66 if rows <= 64 else 0)
    assert plan == (2, 64)
    assert fused_lstm.narrow_plan(16, 128, 4096, lambda C, rows: 0) is None


def test_cpu_narrow_route_launches_no_kernel():
    """On CPU tensors the narrow route's wrapper runs the plain version
    and no counter moves; the stack neither packs nor caches narrow
    weights there."""
    xs, p = make_layer(25, (16,), 128, B=5)
    tx, w_ih, b, w_hh = tensors(xs, p)
    before = dict(fused_lstm.launches)
    for seq_out in (True, False):
        got = fused_lstm.layer_f32_narrow(tx, w_ih, b, w_hh, 128, seq_out)
        want = plain.bilstm_layer(tx, w_ih, b, w_hh, 128, seq_out)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    layer = BiLSTMLayer(16, 128)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    with torch.no_grad():
        fused_lstm.bilstm_stack_fused_tm(tx, [layer], 128)
    assert fused_lstm.launches == before
    assert "_k1_narrow_packed" not in layer.__dict__
