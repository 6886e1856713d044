"""K1's float32 route in the port (deepsignal_plant_tpu_torch.ops.fused_lstm):
the input projection out of the time loop (a 3xTF32 tensor-core kernel on
the card, over W_ih packed once per model in tf32 hi and lo planes), then
the recurrence storing h as K1 does (ops/recurrence.py::lstm_recurrence_k1),
and the rules that pick its kernels.

On the CPU the wrappers run the kernels' plain versions
(ops/lstm.py::input_projection, lstm_recurrence and k1_outputs), which
these tests hold against the JAX package's fused Pallas kernel in
interpret mode, with numpy inputs from a seed handed to both. Tolerance
2e-5: the same f32 math, with x@W_ih and h@W_hh summed in two passes
(another order of f32 additions) over 13 steps. The packer's tf32 split
is held to 2^-21 of each weight: hi keeps 11 significant bits, lo another
11, rounded to nearest, so hi + lo is within 2^-22 relative plus lo's own
rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsignal_plant_tpu.ops.pallas_fused import \
    bilstm_layer_fused as jax_fused_layer
from deepsignal_plant_tpu_torch.models.bilstm import BiLSTMLayer
from deepsignal_plant_tpu_torch.ops import fused_lstm, recurrence
from deepsignal_plant_tpu_torch.ops import lstm as plain

T, B = 13, 37
TOL = 2e-5
# the H100's cluster capacities of the float32 forward cluster kernel, as
# its occupancy query reported them (PERF.md): 15 clusters of 8 blocks at
# any row tile; 62 clusters of 4 up to 32-row tiles (two blocks an SM),
# 30 above
H100_SMS = 132


def h100_capacity(C, rows):
    return 15 if C == 8 else (62 if rows <= 32 else 30)


def make_layer(seed, Fs, H, Bn=B):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    xs = [rng.normal(size=(T, Bn, F)).astype(np.float32) for F in Fs]
    p = {"w_ih": rng.uniform(-k, k, (2, sum(Fs), 4 * H)).astype(np.float32),
         "w_hh": rng.uniform(-k, k, (2, H, 4 * H)).astype(np.float32),
         "b": (rng.uniform(-k, k, (2, 4 * H))
               + rng.uniform(-k, k, (2, 4 * H))).astype(np.float32)}
    return xs, p


@pytest.mark.parametrize("seq_out", [True, False])
@pytest.mark.parametrize("Fs", [(7,), (16,), (16, 16)],
                         ids=["seq_F7", "signal_F16", "split_16_16"])
@pytest.mark.parametrize("H", [16, 32])
def test_projection_then_recurrence_matches_jax_fused_kernel(H, Fs, seq_out):
    """The split route's plain versions composed (projection, K2's
    recurrence, K1's output order), and the route's wrappers on the CPU,
    against JAX bilstm_layer_fused in interpret mode at float32."""
    xs, p = make_layer(11, Fs, H)
    tx = tuple(torch.from_numpy(x) for x in xs)
    w_ih, b, w_hh = (torch.from_numpy(p[k]) for k in ("w_ih", "b", "w_hh"))
    xproj = plain.input_projection(tx, w_ih, b)
    assert xproj.shape == (T, 2, B, 4 * H) and xproj.dtype == torch.float32
    got = plain.k1_outputs(plain.lstm_recurrence(xproj, w_hh, H), seq_out)
    wrapped = recurrence.lstm_recurrence_k1(
        fused_lstm.input_projection(tx, w_ih, b), w_hh, H, seq_out,
        fused_lstm.launches)
    routed = fused_lstm.layer_f32_split(tx, w_ih, b, w_hh, H, seq_out)
    want = jax_fused_layer(tuple(jnp.asarray(x) for x in xs),
                           jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
                           jnp.asarray(p["w_hh"]), H, seq_out=seq_out,
                           block_b=8, interpret=True)
    for g, r, q, w in zip(got, wrapped, routed, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape == ((T if seq_out else 1), B, H)
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0)
        assert torch.equal(g, r)
        np.testing.assert_allclose(q.numpy(), w, atol=TOL, rtol=0)


def test_projection_flips_direction_one():
    """xproj[s, 1] is time T-1-s's projection; xproj[s, 0] time s's."""
    xs, p = make_layer(12, (16,), 8)
    x = torch.from_numpy(xs[0])
    w_ih, b = torch.from_numpy(p["w_ih"]), torch.from_numpy(p["b"])
    xproj = plain.input_projection((x,), w_ih, b)
    for s in (0, 5, T - 1):
        torch.testing.assert_close(xproj[s, 0], x[s] @ w_ih[0] + b[0])
        torch.testing.assert_close(xproj[s, 1],
                                   x[T - 1 - s] @ w_ih[1] + b[1])


def tf32_round(x: np.ndarray) -> np.ndarray:
    """x rounded to tf32 (10 mantissa bits), to nearest, ties away from
    zero, by integer ops on the float32 bits (numpy)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


@pytest.mark.parametrize("Fa,Fb,H", [(7, 0, 128), (16, 0, 128),
                                     (128, 128, 256), (256, 256, 256),
                                     (5, 3, 12)])
def test_packer_splits_and_lays_out_the_weights(Fa, Fb, H):
    """pack_proj_weights: (2, 4H, Kp) hi and lo planes, K-major, each
    input's rows zero-padded to the 32-wide K slab; hi has its low 13
    bits zero and is w rounded to tf32; hi + tf32(lo) recovers w within
    2^-21 of it."""
    _, p = make_layer(13, (Fa,) + ((Fb,) if Fb else ()), H, Bn=2)
    w = torch.from_numpy(p["w_ih"])
    hi, lo = fused_lstm.pack_proj_weights(w, Fa)
    Kpa = fused_lstm.proj_k(Fa)
    Kp = Kpa + fused_lstm.proj_k(Fb)
    assert Kpa % 32 == 0 and Kp % 32 == 0 and Kpa - 32 < Fa <= Kpa
    for plane in (hi, lo):
        assert plane.shape == (2, 4 * H, Kp) and plane.dtype == torch.float32
        assert plane.is_contiguous()
        assert not (plane.view(torch.int32) & 0x1FFF).any()
        assert not plane[:, :, Fa:Kpa].any()
        assert not plane[:, :, Kpa + Fb:].any()

    def rows_of(plane):                    # back to (2, F, 4H)
        return torch.cat([plane[:, :, :Fa], plane[:, :, Kpa:Kpa + Fb]],
                         2).transpose(1, 2)

    rows, lows = rows_of(hi), rows_of(lo)
    np.testing.assert_array_equal(rows.numpy(), tf32_round(p["w_ih"]))
    lo_t = tf32_round(lows.numpy())
    err = np.abs(rows.numpy().astype(np.float64) + lo_t - p["w_ih"])
    assert (err <= 2.0 ** -21 * np.abs(p["w_ih"])).all()
    # the split the kernels apply to x, on values of both signs and
    # magnitudes, matches the numpy rounding
    x = torch.from_numpy(np.random.default_rng(1).normal(
        scale=[[1e-3], [1.0], [1e3]], size=(3, 1000)).astype(np.float32))
    h, l = fused_lstm.tf32_split(x)
    np.testing.assert_array_equal(h.numpy(), tf32_round(x.numpy()))
    assert ((h.double() + l.double() - x.double()).abs()
            <= 2.0 ** -21 * x.double().abs()).all()


def test_packed_proj_weights_cached_until_w_ih_changes():
    """packed_proj_weights packs once per model and row split: the same
    planes until an in-place update of w_ih (an optimizer step), a new
    w_ih, or another row split."""
    _, p = make_layer(14, (16, 16), 8, Bn=2)
    layer = BiLSTMLayer(32, 8)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    first = fused_lstm.packed_proj_weights(layer, 16)
    assert fused_lstm.packed_proj_weights(layer, 16) is first
    with torch.no_grad():
        layer.w_hh.add_(1.0)               # read as it is, not packed
        layer.b.add_(1.0)
    assert fused_lstm.packed_proj_weights(layer, 16) is first
    with torch.no_grad():
        layer.w_ih.mul_(2.0)
    second = fused_lstm.packed_proj_weights(layer, 16)
    assert second is not first
    torch.testing.assert_close(second[0], first[0] * 2.0, rtol=2e-3,
                               atol=0)
    other = fused_lstm.packed_proj_weights(layer, 8)
    assert other is not second and other[0].shape == (2, 32, 64)
    assert fused_lstm.packed_proj_weights(layer, 8) is other
    layer.w_ih = torch.nn.Parameter(layer.w_ih.detach().clone())
    assert fused_lstm.packed_proj_weights(layer, 8) is not other


@pytest.mark.parametrize("B", [4096, 1016, 512, 37])
@pytest.mark.parametrize("H", [128, 256])
def test_k1_plan_covers_every_row_within_shared_memory(H, B):
    """K1's recurrence plan (recurrence_plan of the float32 forward, K2's)
    on the H100's capacities: clusters of H/32 blocks, a row tile of the
    float32 forward kernel that fits a block's shared memory, and row
    tiles that cover the B rows once (as many waves as they take); at
    call_mods' tiles the plans the H100 ran fastest (PERF.md: 64 rows at
    H=256 and 32 at H=128 for 4,096 rows), at the training batch the
    one-wave plans (80 and 32 rows)."""
    plan = recurrence.recurrence_plan(0, B, H, h100_capacity, torch.float32)
    assert plan is not None
    C, rows = plan
    assert C == H // 32 and rows % 16 == 0
    assert rows in recurrence._CL_ROWS[torch.float32][0]
    assert recurrence.recurrence_smem(0, H, rows, torch.float32) <= 232_448
    tiles = -(-B // rows)
    assert tiles * rows >= B > (tiles - 1) * rows
    if B == 4096:
        assert rows == (64 if H == 256 else 32)
    if B == 512:
        assert rows == (80 if H == 256 else 32)


@pytest.mark.parametrize("H", [8, 96, 192, 512])
def test_k1_plan_takes_the_streaming_kernel_off_the_cluster_widths(H):
    assert recurrence.recurrence_plan(0, 4096, H, h100_capacity,
                                      torch.float32) is None
    assert recurrence.k1_rec_plan(4096, H, h100_k1w_capacity,
                                  h100_capacity) == ("stream", None)


# the H100's capacities of K1's wgmma recurrence, as its occupancy query
# reported them (PERF.md): one block an SM at either width, so 132
# clusters of 1, 66 of 2 and 30 of 4 (clusters of 4 fit only 120 of the
# 132 SMs)
H100_K1W_CLUSTERS = {1: 132, 2: 66, 4: 30}


def h100_k1w_capacity(C, stages):
    return H100_K1W_CLUSTERS[C]


@pytest.mark.parametrize("B", [4096, 1016, 512, 37])
@pytest.mark.parametrize("H", [128, 256])
def test_k1_wgmma_plan_covers_every_row_within_shared_memory(H, B):
    """K1's wgmma recurrence plan (k1w_plan) on the H100's capacities:
    the ring the H100 ran fastest (K1W_STAGES: 5 stages at H = 256, all
    that fit a block's shared memory beside h; 4 at H = 128), 64-row
    tiles that cover the B rows once in clusters of at most that many
    tiles, and one wave of them."""
    C, stages, waves = recurrence.k1w_plan(B, H, h100_k1w_capacity)
    assert stages == recurrence.K1W_STAGES[H] == {128: 4, 256: 5}[H]
    assert 2 <= stages <= recurrence.K1W_MAX_STAGES
    assert recurrence.k1w_smem(H, stages) <= 232_448
    assert H == 128 or recurrence.k1w_smem(H, stages + 1) > 232_448
    tiles = -(-B // 64)
    assert tiles * 64 >= B > (tiles - 1) * 64
    assert C in recurrence.K1W_CLUSTERS and C <= tiles
    blocks = 2 * -(-tiles // C) * C
    assert blocks >= 2 * tiles and waves == 1
    assert blocks // C <= H100_K1W_CLUSTERS[C]


@pytest.mark.parametrize("B,H,kind", [
    (4096, 256, "wgmma"), (4096, 128, "wgmma"), (4093, 256, "wgmma"),
    (1016, 256, "cluster"), (1016, 128, "cluster"), (512, 256, "cluster"),
    (37, 256, "cluster"), (37, 128, "cluster")])
def test_k1_rec_plan_takes_the_kernel_the_h100_ran_fastest(B, H, kind):
    """k1_rec_plan on the H100's capacities: K1's wgmma recurrence at
    call_mods' 4096-row tiles (one wave of 64-row blocks against 5 to 9
    waves of the cluster kernel), the cluster kernel at the 1,016-row tail
    and below, where both run one to three short waves and the cluster
    kernel was as fast or faster (PERF.md); inside force_k1_rec(kind)
    kernel ``kind`` everywhere."""
    got, plan = recurrence.k1_rec_plan(B, H, h100_k1w_capacity,
                                       h100_capacity)
    assert got == kind
    if kind == "wgmma":
        assert plan == recurrence.k1w_plan(B, H, h100_k1w_capacity)[:2]
    else:
        assert plan == recurrence.recurrence_plan(0, B, H, h100_capacity,
                                                  torch.float32)
    for forced in ("wgmma", "cluster"):
        with recurrence.force_k1_rec(forced):
            assert recurrence.k1_rec_plan(B, H, h100_k1w_capacity,
                                          h100_capacity)[0] == forced
    assert recurrence.k1_rec_plan(B, H, h100_k1w_capacity,
                                  h100_capacity)[0] == kind


@pytest.mark.parametrize("H", [128, 256])
def test_rec_packer_lays_out_w_hh_in_stream_order(H):
    """pack_rec_weights: (2, stages, 2 warpgroups, (hi, lo), 128, 16),
    each element where the kernel reads it, by the layout's own formula
    against the plain W_hh: stage cc * H/16 + kb, warpgroup w, packed
    column n = 32 ug + 8 gate + e is unit 32 (w H/64 + cc) + 8 ug + e of
    gate ``gate``; k of slab kb is W_hh's row 16 kb + k, its 16-byte chunk
    k // 4 at chunk (k // 4) ^ ((n // 2) % 4) of the row. hi is W rounded
    to tf32; hi + tf32(lo) recovers W within 2^-21 of it."""
    _, p = make_layer(16, (8,), H, Bn=2)
    w_hh = p["w_hh"]
    packed = fused_lstm.pack_rec_weights(torch.from_numpy(w_hh))
    nch, nks = H // 64, H // 16
    assert packed.shape == (2, nch * nks, 2, 2, 128, 16)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert not (packed.view(torch.int32) & 0x1FFF).any()
    d, i, w, n, col = np.meshgrid(np.arange(2), np.arange(nch * nks),
                                  np.arange(2), np.arange(128),
                                  np.arange(16), indexing="ij")
    cc, kb = i // nks, i % nks
    k = kb * 16 + 4 * ((col // 4) ^ ((n // 2) % 4)) + col % 4
    unit = 32 * (w * nch + cc) + 8 * (n // 32) + n % 8
    want = w_hh[d, k, ((n // 8) % 4) * H + unit]
    hi, lo = packed[:, :, :, 0].numpy(), packed[:, :, :, 1].numpy()
    np.testing.assert_array_equal(hi, tf32_round(want))
    err = np.abs(hi.astype(np.float64) + tf32_round(lo) - want)
    assert (err <= 2.0 ** -21 * np.abs(want)).all()
    # every weight once, in one stage of one direction
    assert sorted(np.abs(want[0]).ravel()) == sorted(np.abs(w_hh[0]).ravel())


def test_packed_rec_weights_cached_until_w_hh_changes():
    """packed_rec_weights packs once per model: the same planes until an
    in-place update of w_hh (an optimizer step) or a new w_hh; f32_packed
    gives the split route both packings at the wgmma kernel's widths, the
    projection's alone elsewhere."""
    _, p = make_layer(17, (16, 16), 128, Bn=2)
    layer = BiLSTMLayer(32, 128)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    first = fused_lstm.packed_rec_weights(layer)
    assert fused_lstm.packed_rec_weights(layer) is first
    with torch.no_grad():
        layer.w_ih.add_(1.0)               # the projection's, not packed here
        layer.b.add_(1.0)
    assert fused_lstm.packed_rec_weights(layer) is first
    with torch.no_grad():
        layer.w_hh.mul_(2.0)
    second = fused_lstm.packed_rec_weights(layer)
    assert second is not first
    torch.testing.assert_close(second[:, :, :, 0], first[:, :, :, 0] * 2.0,
                               rtol=0, atol=0)
    proj, rec = fused_lstm.f32_packed(layer, "split", 16)
    assert rec is second and proj is fused_lstm.packed_proj_weights(layer, 16)
    layer.w_hh = torch.nn.Parameter(layer.w_hh.detach().clone())
    assert fused_lstm.packed_rec_weights(layer) is not second
    narrow = BiLSTMLayer(32, 16)
    assert fused_lstm.f32_packed(narrow, "split", 16)[1] is None


# the H100's capacities of the narrow kernel's plans (clusters of 2 at H =
# 128, of 8 at H = 256; one block an SM), as its occupancy query
# reported them (PERF.md)
H100_NARROW_CLUSTERS = {2: 66, 8: 15}


@pytest.mark.parametrize("F,H,B,route", [
    (7, 128, 4096, "narrow"), (16, 128, 4096, "narrow"),
    (7, 128, 1016, "narrow"), (16, 128, 1016, "narrow"),
    (256, 256, 4096, "split"), (512, 256, 4096, "split"),
    (512, 256, 1016, "split"), (16, 128, 37, "split"),
    (31, 8, 8448, "inloop"), (31, 8, 8192, "split"),
    (32, 8, 8448, "split"), (7, 128, 512, "narrow"),
    (16, 128, 256, "narrow"), (7, 128, 255, "split"),
    (16, 256, 512, "narrow"), (16, 256, 256, "narrow"),
    (16, 256, 93, "split"), (24, 128, 4096, "inloop"),
    (24, 128, 1016, "split")])
def test_f32_route_rule(F, H, B, route):
    """f32_route on the H100's 132 SMs and its narrow plans: the narrow
    kernel wherever it has a plan (the branches: F <= 16 at H = 128 and
    256) from NARROW_MIN_ROWS = 256 rows up, where the H100 ran it
    fastest; else the in-loop kernel for inputs narrower than the
    projection's K slab once its grid fills the card; the projection and
    the recurrence elsewhere (the comb layers, and the branches' short
    tiles: denoise's 93-row tail ran faster there)."""
    narrow = fused_lstm.narrow_plan(
        F, H, B, lambda C, rows: H100_NARROW_CLUSTERS[C])
    assert fused_lstm.f32_route(F, H, B, H100_SMS, narrow) == route


def test_inloop_rows_follow_the_kernel_block():
    assert [fused_lstm.inloop_rows(H) for H in (8, 100, 128, 256, 512)] == \
        [128, 32, 32, 16, 16]


def test_cpu_route_launches_no_kernel():
    """On CPU tensors the float32 routes' wrappers run the plain versions
    and no counter moves."""
    xs, p = make_layer(15, (16, 16), 16)
    tx = tuple(torch.from_numpy(x) for x in xs)
    w_ih, b, w_hh = (torch.from_numpy(p[k]) for k in ("w_ih", "b", "w_hh"))
    before = dict(fused_lstm.launches)
    rbefore = dict(recurrence.launches)
    xproj = fused_lstm.input_projection(tx, w_ih, b)
    recurrence.lstm_recurrence_k1(xproj, w_hh, 16, False, fused_lstm.launches)
    fused_lstm.bilstm_layer_fused(tx, w_ih, b, w_hh, 16)
    want = fused_lstm.layer_f32_split(tx, w_ih, b, w_hh, 16)
    for g, w in zip(fused_lstm.layer_f32_inloop(tx, w_ih, b, w_hh, 16), want):
        assert torch.equal(g, w)
    layer = BiLSTMLayer(32, 16)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    with torch.no_grad():
        fused_lstm.bilstm_stack_fused_tm(tx, [layer], 16)
    assert fused_lstm.launches == before
    assert recurrence.launches == rbefore
    assert "_k1_proj_packed" not in layer.__dict__
    assert "_k1_rec_packed" not in layer.__dict__
