"""The port's trainable BiLSTM recurrence against the JAX package's Pallas
kernels (ops/pallas_lstm.py) run in interpret mode on the CPU.

On CPU tensors the wrappers of ops/recurrence.py run the plain versions
of K2, K3 and K4 (ops/lstm.py), and BiLSTMRecurrence wraps them as
autograd does on the card. Inputs are made with numpy from a seed and
handed to both packages. Tolerances are those of tests/test_pallas_vjp.py
(the Pallas kernels against autodiff through the JAX scan): float32
primal 1e-5, dxproj 2e-4, dW_hh 2e-3; bfloat16 2e-2, where both sides
round h, the saved gates and da to bf16 at the same points, so only a
summation order inside an f32 accumulation can move a rounding by an ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsignal_plant_tpu.ops import pallas_lstm
from deepsignal_plant_tpu_torch.ops import lstm as plain
from deepsignal_plant_tpu_torch.ops import recurrence

H = 16
T = 7


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_lstm, "_INTERPRET", True)


def inputs(B, seed=0):
    """xproj ~ N(0, 1), w_hh ~ U(-1/sqrt(H), 1/sqrt(H)), a cotangent
    ~ N(0, 1), as float32 numpy arrays (the shapes of test_pallas_vjp)."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    return (rng.normal(size=(T, 2, B, 4 * H)).astype(np.float32),
            rng.uniform(-k, k, (2, H, 4 * H)).astype(np.float32),
            rng.normal(size=(T, 2, B, H)).astype(np.float32))


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("B", [8, 13])
def test_k2_matches_pallas(B):
    xproj, w_hh, _ = inputs(B)
    want = pallas_lstm.bilstm_recurrence_pallas(j(xproj), j(w_hh), H,
                                                interpret=True)
    got = recurrence.lstm_recurrence(t(xproj), t(w_hh), H)
    assert got.shape == (T, 2, B, H) and got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B", [8, 13])
def test_k3_matches_pallas(B):
    xproj, w_hh, _ = inputs(B)
    ys, cs, gs = pallas_lstm._recurrence_fwd_save(j(xproj), j(w_hh), H,
                                                  interpret=True)
    got = recurrence.lstm_recurrence_fwd_save(t(xproj), t(w_hh), H)
    for name, g, w in zip(("ys", "cs", "gates"), got, (ys, cs, gs)):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(f32(g), f32(w)[:, :, :B], atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("B", [8, 13])
def test_k4_matches_pallas(B):
    """K4 on the same residuals: the JAX kernel takes B padded to its
    128-row block; its padded rows carry zero states and cotangents."""
    xproj, w_hh, dys = inputs(B)
    ys, cs, gs = pallas_lstm._recurrence_fwd_save(j(xproj), j(w_hh), H,
                                                  interpret=True)
    Bp = ys.shape[2]
    dys_p = jnp.pad(j(dys), ((0, 0), (0, 0), (0, Bp - B), (0, 0)))
    dx, dw = pallas_lstm._recurrence_bwd(dys_p, ys, cs, gs, j(w_hh), H,
                                         interpret=True)
    got_dx, got_dw = plain.lstm_recurrence_bwd(
        t(dys), t(f32(ys)[:, :, :B]), t(f32(cs)[:, :, :B]),
        t(f32(gs)[:, :, :B]), t(w_hh), H)
    np.testing.assert_allclose(f32(got_dx), f32(dx)[:, :, :B], atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(f32(got_dw), f32(dw), atol=2e-3, rtol=2e-3)
    # the wrappers' halves are the same two functions on CPU tensors
    dx2 = recurrence.lstm_recurrence_bwd_dx(
        t(dys), t(f32(cs)[:, :, :B]), t(f32(gs)[:, :, :B]), t(w_hh), H)
    np.testing.assert_array_equal(dx2.numpy(), got_dx.numpy())
    dw2 = recurrence.lstm_dw_hh(t(f32(ys)[:, :, :B]), dx2)
    np.testing.assert_array_equal(dw2.numpy(), got_dw.numpy())


def port_grads(xproj, w_hh, dys, dtype):
    xp = t(xproj, dtype).requires_grad_(True)
    w = t(w_hh, dtype).requires_grad_(True)
    ys = recurrence.bilstm_recurrence_trainable(xp, w, H)
    (ys.float() * t(dys)).sum().backward()
    return ys.detach(), xp.grad, w.grad


def jax_grads(xproj, w_hh, dys, dtype):
    def loss(xp, w):
        ys = pallas_lstm.bilstm_recurrence_trainable(xp, w, H)
        return jnp.sum(ys.astype(jnp.float32) * j(dys))

    xp, w = j(xproj, dtype), j(w_hh, dtype)
    ys = pallas_lstm.bilstm_recurrence_trainable(xp, w, H)
    gx, gw = jax.grad(loss, argnums=(0, 1))(xp, w)
    return ys, gx, gw


@pytest.mark.parametrize("B", [8, 13])
def test_trainable_primal_and_grads_match_jax(B):
    xproj, w_hh, dys = inputs(B)
    ys, gx, gw = port_grads(xproj, w_hh, dys, torch.float32)
    want_ys, want_gx, want_gw = jax_grads(xproj, w_hh, dys, jnp.float32)
    np.testing.assert_allclose(f32(ys), f32(want_ys), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(f32(gx), f32(want_gx), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(f32(gw), f32(want_gw), atol=2e-3, rtol=2e-3)


def test_trainable_bf16_matches_jax():
    """bf16 storage: the primal and both gradients in bf16, dW_hh rounded
    from its f32 sum to w_hh's dtype as the JAX backward does."""
    xproj, w_hh, dys = inputs(13, seed=1)
    ys, gx, gw = port_grads(xproj, w_hh, dys, torch.bfloat16)
    assert ys.dtype == gx.dtype == gw.dtype == torch.bfloat16
    want_ys, want_gx, want_gw = jax_grads(xproj, w_hh, dys, jnp.bfloat16)
    assert want_gw.dtype == jnp.bfloat16
    for name, g, w in (("ys", ys, want_ys), ("dxproj", gx, want_gx),
                       ("dW_hh", gw, want_gw)):
        np.testing.assert_allclose(f32(g), f32(w), atol=2e-2, rtol=2e-2,
                                   err_msg=name)


def test_trainable_picks_autograd_or_k2():
    """Under autograd the recurrence is BiLSTMRecurrence (K3 forward, K4
    backward); without grad, or with no input that needs it, it is K2,
    the JAX custom VJP's primal. CPU tensors launch nothing."""
    xproj, w_hh, _ = inputs(5)
    before = dict(recurrence.launches)
    xp = t(xproj).requires_grad_(True)
    ys = recurrence.bilstm_recurrence_trainable(xp, t(w_hh), H)
    assert type(ys.grad_fn).__name__ == "BiLSTMRecurrenceBackward"
    with torch.no_grad():
        ys0 = recurrence.bilstm_recurrence_trainable(xp, t(w_hh), H)
    assert ys0.grad_fn is None
    ys1 = recurrence.bilstm_recurrence_trainable(t(xproj), t(w_hh), H)
    assert ys1.grad_fn is None
    np.testing.assert_array_equal(ys.detach().numpy(), ys0.numpy())
    np.testing.assert_array_equal(ys0.numpy(), ys1.numpy())
    assert recurrence.launches == before


def test_wrappers_reject_other_devices_and_dtypes():
    xproj, w_hh, _ = inputs(4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        recurrence.lstm_recurrence(t(xproj).to("meta"), t(w_hh).to("meta"),
                                   H)
    with pytest.raises(TypeError):
        recurrence._dims("lstm_recurrence_fwd", t(xproj).half(), H, 4 * H)
    with pytest.raises(ValueError):
        recurrence._dims("lstm_recurrence_fwd", t(xproj), H, 2 * H)


@pytest.mark.parametrize("T,B,H", [(13, 512, 256), (13, 512, 128),
                                   (13, 509, 256), (1, 512, 256), (2, 1, 8),
                                   (13, 37, 20), (5, 3000, 96)])
def test_dw_hh_split_plan_covers_every_row_once(T, B, H):
    """The dW_hh kernel's split-K plan: ranges of K = (T-1)*B rows, in
    order, that cover every row exactly once (one empty split when
    K = 0); rows a multiple of the bf16 kernel's 64-row slab."""
    splits, rows = recurrence.dw_hh_split_plan(T, B, H, sms=132)
    K = (T - 1) * B
    ranges = [(z * rows, min((z + 1) * rows, K)) for z in range(splits)]
    assert [k for a, b in ranges for k in range(a, b)] == list(range(K))
    assert rows % 64 == 0
    if K == 0:
        assert (splits, rows) == (1, 0)
    else:
        assert all(b > a for a, b in ranges)


def test_dw_hh_split_plan_fills_the_card_at_the_training_shapes():
    """At batch 512 on an H100 (132 SMs), one wave of blocks (at most two
    per SM): 128 x 128 output tiles per direction times the splits."""
    for H, want_splits in ((128, 16), (256, 8)):
        splits, rows = recurrence.dw_hh_split_plan(13, 512, H, sms=132)
        tiles = 2 * (H // 128) * (4 * H // 128)
        assert splits == want_splits
        assert 128 <= tiles * splits <= 264


KINDS = [0, 1, 2]            # K2, K3, K4's recurrence
# the storage dtypes, each with its cluster kernels
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "f32"])
UNITS = {torch.bfloat16: 64, torch.float32: 32}     # hidden units a block
WAVES = {torch.bfloat16: 1, torch.float32: 2}       # waves a plan may take


def card(cap4: int, kind: int, H: int, dtype=torch.bfloat16):
    """A card's cluster capacity as the kernels' occupancy query reports
    it, modelled on an H100's: ``cap4`` clusters of 4 blocks at one block
    per SM (30 on the H100 measured), twice as many clusters of 2, half as
    many of 8, and twice again where a block's shared memory lets two
    share an SM."""
    def capacity(C, rows):
        per_sm = 2 if recurrence.recurrence_smem(kind, H, rows, dtype) <= \
            113_000 else 1
        return cap4 * 4 // C * per_sm
    return capacity


def waves(B, rows, cap):
    """Waves of clusters of a grid of 2 * ceil(B / rows) clusters."""
    return -(-2 * -(-B // rows) // cap)


@DTYPES
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", [512, 509, 1, 37, 100])
@pytest.mark.parametrize("H", [128, 256])
def test_recurrence_plan_covers_every_row_once(H, B, kind, dtype):
    """The plan's row tiles, [t*rows, min((t+1)*rows, B)), cover each of
    the B rows exactly once; the cluster holds H/64 (bfloat16) or H/32
    (float32) blocks."""
    cluster, rows = recurrence.recurrence_plan(
        kind, B, H, card(30, kind, H, dtype), dtype)
    assert cluster == H // UNITS[dtype]
    assert rows in (16, 32, 48) or (dtype == torch.float32 and kind < 2
                                     and rows in (64, 80))
    tiles = -(-B // rows)
    covered = [b for t in range(tiles)
               for b in range(t * rows, min((t + 1) * rows, B))]
    assert covered == list(range(B))


@DTYPES
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("H", [128, 256])
def test_recurrence_plan_stays_within_shared_memory(H, kind, dtype):
    """Every plan the function can give, at any capacity, keeps a block
    at or under Hopper's 232,448 bytes of shared memory."""
    for cap4 in (1, 8, 28, 30, 33, 1000):
        for B in (1, 16, 37, 509, 512, 2000):
            plan = recurrence.recurrence_plan(
                kind, B, H, card(cap4, kind, H, dtype), dtype)
            if plan is not None:
                assert recurrence.recurrence_smem(kind, H, plan[1],
                                                  dtype) <= 232_448


@DTYPES
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cap4", [28, 29, 30, 31, 32, 33])
@pytest.mark.parametrize("B", [512, 509])
@pytest.mark.parametrize("H", [128, 256])
def test_recurrence_plan_fits_one_wave_at_the_training_shapes(H, B, cap4,
                                                              kind, dtype):
    """At the training batch the plan always exists and its 2 *
    ceil(B / rows) clusters fit the card in the waves the dtype allows
    (bfloat16 one, float32 two): a capacity of 28 to 33 clusters of 4 (the
    H100 holds 30, not 132 / 4)."""
    capacity = card(cap4, kind, H, dtype)
    cluster, rows = recurrence.recurrence_plan(kind, B, H, capacity, dtype)
    assert waves(B, rows, capacity(cluster, rows)) <= WAVES[dtype]


def test_recurrence_plan_on_the_measured_h100():
    """The H100's capacities (30 clusters of 4; 66 of 2, 132 at <= 113 KB
    a block): H=256 takes clusters of 4 with 48-row tiles (32-row tiles
    need 32 clusters), H=128 clusters of 2 with 16-row tiles."""
    for kind in KINDS:
        assert recurrence.recurrence_plan(kind, 512, 256,
                                          card(30, kind, 256)) == (4, 48)
        assert recurrence.recurrence_plan(kind, 512, 128,
                                          card(30, kind, 128)) == (2, 16)
        assert recurrence.recurrence_plan(kind, 512, 256,
                                          card(32, kind, 256)) == (4, 32)


@DTYPES
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("H", [1, 8, 20, 64, 96, 192, 320, 384, 512])
def test_recurrence_plan_reroutes_other_widths(H, kind, dtype):
    """The shape rule: only H = 128 and 256 (clusters of 2 and 4 blocks of
    64 units in bfloat16, of 4 and 8 blocks of 32 units in float32) take
    the cluster kernels; every other H takes the streaming kernel,
    whatever the card holds."""
    assert recurrence.recurrence_plan(kind, 512, H, lambda C, rows: 10**6,
                                      dtype) is None


@pytest.mark.parametrize("kind", KINDS)
def test_recurrence_plan_refuses_a_second_wave(kind):
    """Where no row tile fits the card in one wave (4096 rows at the
    H100's capacity, or a card that holds no cluster), the plan is the
    streaming kernel, never a second wave of clusters."""
    for H in (128, 256):
        assert recurrence.recurrence_plan(kind, 4096, H,
                                          card(30, kind, H)) is None
        assert recurrence.recurrence_plan(kind, 1, H,
                                          lambda C, rows: 0) is None


@pytest.mark.parametrize("kind", [2])
def test_f32_recurrence_plan_refuses_a_third_wave(kind):
    """float32's backward takes a second wave of clusters, never a third:
    at 4096 rows on the H100's capacity H=256 takes the streaming kernel,
    H=128 at most two waves; on a card that holds no cluster, the
    streaming kernel."""
    f32 = torch.float32
    assert recurrence.recurrence_plan(kind, 4096, 256,
                                      card(30, kind, 256, f32), f32) is None
    for B in (4096, 8192, 100_000):
        capacity = card(30, kind, 128, f32)
        plan = recurrence.recurrence_plan(kind, B, 128, capacity, f32)
        if plan is not None:
            assert waves(B, plan[1], capacity(*plan)) <= 2
    for H in (128, 256):
        assert recurrence.recurrence_plan(kind, 1, H, lambda C, rows: 0,
                                          f32) is None


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("H", [128, 256])
def test_f32_forward_plan_takes_the_waves_it_needs(H, kind):
    """float32's forward (K2, K3) takes as many waves of clusters as its
    rows need, the least estimated time waves x (ceil(rows / 32) + 0.5):
    at 4096 rows (call_mods' and the fused-off inference tile) on the
    H100's capacities (15 clusters of 8; 62 of 4 up to 32-row tiles, 30
    above) 64-row tiles in 9 waves at H=256, 32-row tiles in 5 at H=128;
    on a card that holds no cluster, the streaming kernel."""
    f32 = torch.float32

    def h100(C, rows):
        return 15 if C == 8 else (62 if rows <= 32 else 30)

    plan = recurrence.recurrence_plan(kind, 4096, H, h100, f32)
    assert plan == (H // 32, 64 if H == 256 else 32)
    assert waves(4096, plan[1], h100(*plan)) == (9 if H == 256 else 5)
    for B in (8192, 100_000):
        plan = recurrence.recurrence_plan(kind, B, H, h100, f32)
        assert plan is not None and plan[0] == H // 32
    assert recurrence.recurrence_plan(kind, 1, H, lambda C, rows: 0,
                                      f32) is None


@pytest.mark.parametrize("kind", KINDS)
def test_f32_recurrence_plan_prefers_fewer_waves(kind):
    """Among the row tiles that fit shared memory, the fewest waves, then
    the smallest tile (the backward; the forward's cost rule gives the
    same here): on a card that holds every grid in one wave the 16-row
    tile; where only larger tiles fit one wave, the smallest of those."""
    dt = torch.float32
    for H in (128, 256):
        C = H // 32
        assert recurrence.recurrence_plan(kind, 512, H, lambda c, r: 10**6,
                                          dt) == (C, 16)
        # 33 clusters at once: 16-row tiles (64 clusters) take two waves,
        # 32-row tiles (32 clusters) one
        assert recurrence.recurrence_plan(kind, 512, H, lambda c, r: 33,
                                          dt) == (C, 32)


def test_recurrence_smem_matches_the_kernels_layout():
    """recurrence_smem repeats csrc/lstm_recurrence.cu's cl_smem: the W_hh
    slice (H x 264 bf16), then two h buffers (rows x (H + 8)) and the
    xproj stage (rows x 264) forward, or the da buffer (rows x 264 bf16)
    and H/64 receive slots (rows x 64 f32) backward."""
    assert recurrence.recurrence_smem(1, 256, 48) == \
        2 * (256 * 264 + 2 * 48 * 264 + 48 * 264)
    assert recurrence.recurrence_smem(2, 256, 48) == \
        2 * (256 * 264 + 48 * 264) + 4 * 4 * 48 * 64
    assert recurrence.recurrence_smem(0, 128, 16) == \
        2 * (128 * 264 + 2 * 16 * 136 + 16 * 264)


def test_f32_recurrence_smem_matches_the_kernels_layout():
    """float32's cl_smem: the W_hh slice (H x 136 f32 forward, H x 132
    backward), then one h buffer (rows x (H + 4)) forward, or the da
    buffer (rows x 132) and H/32 receive slots (rows x 32) backward; the
    largest tiles fit a block, the next ones would not."""
    f32 = torch.float32
    assert recurrence.recurrence_smem(1, 256, 80, f32) == \
        4 * (256 * 136 + 80 * 260) == 222_464
    assert recurrence.recurrence_smem(0, 256, 80, f32) == 222_464
    assert recurrence.recurrence_smem(2, 256, 48, f32) == \
        4 * (256 * 132 + 48 * 132 + 8 * 48 * 32) == 209_664
    assert recurrence.recurrence_smem(0, 128, 32, f32) == \
        4 * (128 * 136 + 32 * 132)
    assert recurrence.recurrence_smem(1, 256, 96, f32) > 232_448
    assert recurrence.recurrence_smem(2, 256, 64, f32) > 232_448


def test_wrappers_ignore_the_stream_choice_on_the_cpu():
    """On CPU tensors ``stream`` changes nothing: the plain versions run
    and no counter moves."""
    xproj, w_hh, dys = inputs(5)
    before = dict(recurrence.launches)
    want = recurrence.lstm_recurrence(t(xproj), t(w_hh), H)
    got = recurrence.lstm_recurrence(t(xproj), t(w_hh), H, stream=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    saved = recurrence.lstm_recurrence_fwd_save(t(xproj), t(w_hh), H,
                                                stream=True)
    dx = recurrence.lstm_recurrence_bwd_dx(t(dys), saved[1], saved[2],
                                           t(w_hh), H, stream=True)
    np.testing.assert_array_equal(dx.numpy(), plain.lstm_recurrence_bwd_dx(
        t(dys), saved[1], saved[2], t(w_hh), H).numpy())
    assert recurrence.launches == before


@pytest.mark.parametrize("sms", [1, 16, 66, 114, 132, 1000])
def test_dw_hh_split_plan_follows_the_sm_count(sms):
    """The wave is the card's: tiles times splits stay within two blocks
    per SM (or one split when a single split's tiles already exceed it),
    splits never fall as SMs are added, and never pass 16."""
    T, B, H = 13, 512, 256
    tiles = 2 * (H // 128) * (4 * H // 128)
    splits, _ = recurrence.dw_hh_split_plan(T, B, H, sms)
    assert 1 <= splits <= 16
    assert splits == 1 or tiles * splits <= 2 * sms
    more, _ = recurrence.dw_hh_split_plan(T, B, H, sms + 1)
    assert more >= splits
