"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the main paths' shapes: the fused BiLSTM layer
(csrc/fused_bilstm.cu) at call_mods' 4096-row tiles, and the trainable
recurrence (csrc/lstm_recurrence.cu: K2, K3, K4 and its dW_hh) at the
training batch of 512.

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
The recurrence kernels are held to REC_TOL times max(1, max |plain|):
float32 2e-5 for the same reason (the cluster kernels' 3xTF32 products
also drop each product's lo*lo term, about 2^-22 of it); bfloat16 2e-2,
as above for h, and for dxproj because da is rounded to bf16 before it
feeds the next step's dh, so one flipped rounding travels back through
the steps.
dW_hh gets identical inputs on both sides and differs only in the order
of its f32 sums over (T-1)*B rows: 1e-5 in both storage types; its
split-K partials are summed in a fixed order, so two launches on the
same inputs agree bit for bit.

call_mods over local cards: the engine over two replicas on card 0
writes one replica's bytes, K1's bfloat16 kernel 5 times a forward tile
of each share; with two or more visible cards, the CLI's default
``--device`` (every card) writes ``--device cuda:0``'s bytes.

K1 has two kernels at bfloat16 (the wgmma kernel, which every layer that
fits takes, k1_bf16_plan; the mma.sync kernel for the rest, and
called directly) and three routes at float32 (the narrow kernel, which
the branches take, f32_route; the 3xTF32 projection kernel and the
float32 recurrence; the in-loop kernel); each check asserts that the
counters of the kernels the layer ran moved and no other.
"""

import numpy as np
import pytest
import torch

from deepsignal_plant_tpu_torch.ops import fused_lstm
from deepsignal_plant_tpu_torch.ops import lstm as plain
from deepsignal_plant_tpu_torch.ops import recurrence
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


def k1_plan(H, B, device):
    """K1's recurrence plan on this card: k1_rec_plan's (kind, plan)."""
    return recurrence.k1_rec_plan_on(device, B, H)


# the counter of each kernel of K1's float32 recurrence, by k1_plan's kind
K1_REC_COUNTERS = {"wgmma": "fused_bilstm_rec_f32_wgmma",
                   "cluster": "fused_bilstm_rec_f32",
                   "stream": "fused_bilstm_rec_f32_stream"}


# K1's float32 routes and its bf16 kernels, called directly
F32_ROUTES = {"narrow": fused_lstm.layer_f32_narrow,
              "split": fused_lstm.layer_f32_split,
              "inloop": fused_lstm.layer_f32_inloop,
              "wgmma": fused_lstm.layer_bf16_wgmma,
              "mma": fused_lstm.layer_bf16_mma}


def expected_k1_launches(F, H, B, dtype, device, f32_route=None):
    """The counters one K1 layer moves: bfloat16 its kernel; float32 the
    kernels of its route (f32_route's, or the one called): the narrow
    kernel, the in-loop kernel, or the projection kernel and the
    recurrence kernel of K1's plan (k1_plan)."""
    want = {k: 0 for k in fused_lstm.launches}
    if dtype == torch.bfloat16:
        plan = fused_lstm.k1_bf16_plan(F, H, B)
        want["fused_bilstm_bf16" if plan is None or f32_route == "mma"
             else "fused_bilstm_bf16_wgmma"] = 1
        return want
    if f32_route is None:
        f32_route = fused_lstm.f32_route_on(device, F, H, B)[0]
    if f32_route in ("narrow", "inloop"):
        want[f"fused_bilstm_f32_{f32_route}"] = 1
        return want
    want["fused_bilstm_proj_f32"] = 1
    want[K1_REC_COUNTERS[k1_plan(H, B, device)[0]]] = 1
    return want


def check_against_plain(Fa, Fb, H, seq_out, B, dtype, device,
                        f32_route=None):
    """One layer against the plain version, through bilstm_layer_fused
    or the route ``f32_route`` (a float32 route or a bf16 kernel, by
    F32_ROUTES) called directly; the counters of
    the kernels it runs move (expected_k1_launches), no other. Returns
    its output."""
    xs, w_ih, b, w_hh = layer_inputs(Fa, Fb, H, B, dtype, device)
    before = dict(fused_lstm.launches)
    layer = F32_ROUTES[f32_route] if f32_route else \
        fused_lstm.bilstm_layer_fused
    got = layer(xs, w_ih, b, w_hh, H, seq_out)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in fused_lstm.launches.items()}
    assert moved == expected_k1_launches(Fa + Fb, H, B, dtype, device,
                                         f32_route)
    want = bilstm_layer(xs, w_ih, b, w_hh, H, seq_out)
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((T if seq_out else 1), B, H)
        assert g.dtype == dtype
        err = (g.float() - w.float()).abs().max().item()
        assert err <= TOL[dtype], f"F=({Fa},{Fb}) H={H} B={B} {dtype}: {err}"
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [4096, 4093])
@pytest.mark.parametrize("layer", list(MAIN_PATH_LAYERS))
def test_kernel_matches_plain(device, layer, B, dtype):
    check_against_plain(*MAIN_PATH_LAYERS[layer], B, dtype, device)


@pytest.mark.parametrize("f32_route", ["split", "inloop"])
@pytest.mark.parametrize("B", [4096, 1016, 77])
@pytest.mark.parametrize("layer", list(MAIN_PATH_LAYERS))
def test_f32_routes_match_plain_and_each_other(device, layer, B, f32_route):
    """K1 at float32 through each of its routes (the projection kernel and
    the recurrence; the in-loop kernel) at the main path's five layers,
    a full tile, call_mods' 1,016-row tail and a ragged 77 rows: each
    against the plain version, the two against each other."""
    Fa, Fb, H, seq_out = MAIN_PATH_LAYERS[layer]
    got = check_against_plain(Fa, Fb, H, seq_out, B, torch.float32, device,
                              f32_route)
    other = "inloop" if f32_route == "split" else "split"
    xs, w_ih, b, w_hh = layer_inputs(Fa, Fb, H, B, torch.float32, device)
    alt = F32_ROUTES[other](xs, w_ih, b, w_hh, H, seq_out)
    for g, a in zip(got, alt):
        assert (g - a).abs().max().item() <= TOL[torch.float32]


# the narrow layers the main paths give the narrow kernel: the branches
# (call_mods' tiles, train's 512-row evaluation tile and a two-rank share
# of it, a ragged 77), a row-split input, and denoise's signal_bilstm
# first layer (H = 256) at its tiles
NARROW_CASES = [(7, 0, 128, B) for B in (4096, 4093, 1016, 512, 256, 77)] + \
    [(16, 0, 128, B) for B in (4096, 4093, 1016, 512, 256)] + \
    [(8, 8, 128, 1000)] + [(16, 0, 256, B) for B in (512, 509, 93, 256)]


@pytest.mark.parametrize("Fa,Fb,H,B", NARROW_CASES)
def test_narrow_kernel_matches_plain_and_the_other_routes(device, Fa, Fb, H,
                                                          B):
    """The narrow kernel (3xTF32 over cluster-resident weight slices) at
    the narrow layers, seq_out both ways: against the plain version, each
    launch moving its own counter alone, and against the split and
    in-loop routes; from NARROW_MIN_ROWS rows up bilstm_layer_fused takes
    it (f32_route), over its packed weights given or made in the call
    with the same bits."""
    for seq_out in (True, False):
        got = check_against_plain(Fa, Fb, H, seq_out, B, torch.float32,
                                  device, "narrow")
        xs, w_ih, b, w_hh = layer_inputs(Fa, Fb, H, B, torch.float32, device)
        for other in ("split", "inloop"):
            alt = F32_ROUTES[other](xs, w_ih, b, w_hh, H, seq_out)
            for g, a in zip(got, alt):
                assert (g - a).abs().max().item() <= TOL[torch.float32]
        route = fused_lstm.f32_route_on(device, Fa + Fb, H, B)[0]
        assert (route == "narrow") == (B >= fused_lstm.NARROW_MIN_ROWS)
        if route != "narrow":
            continue
        packed = fused_lstm.pack_narrow_weights(w_ih, w_hh)
        auto = fused_lstm.bilstm_layer_fused(xs, w_ih, b, w_hh, H, seq_out,
                                             packed=packed)
        for g, a in zip(got, auto):
            assert torch.equal(g, a)


def test_narrow_kernel_refuses_what_it_has_no_plan_for(device):
    """No plan, so the narrow route raises: inputs wider than 16, H other
    than 128 and 256; a float32 layer there takes another route."""
    for Fa, H in ((24, 128), (7, 96)):
        xs, w_ih, b, w_hh = layer_inputs(Fa, 0, H, 64, torch.float32,
                                         device)
        with pytest.raises(ValueError, match="no plan"):
            fused_lstm.layer_f32_narrow(xs, w_ih, b, w_hh, H)
        assert fused_lstm.f32_route_on(device, Fa, H, 64)[0] != "narrow"


@pytest.mark.parametrize("B", [4096, 1016, 77, 1])
@pytest.mark.parametrize("layer", list(MAIN_PATH_LAYERS) + ["odd", "wide"])
def test_projection_kernel_matches_plain(device, layer, B):
    """The float32 projection kernel alone (3xTF32 wgmma) against its
    plain version, K2's xproj contract, at the main path's inputs and at
    odd widths (row split 5 + 3, H=12; 24 + 40, H=96); with the packed
    weights given or made in the call, the same bits."""
    Fa, Fb, H, _ = {"odd": (5, 3, 12, True), "wide": (24, 40, 96, True),
                    **MAIN_PATH_LAYERS}[layer]
    xs, w_ih, b, _ = layer_inputs(Fa, Fb, H, B, torch.float32, device)
    before = fused_lstm.launches["fused_bilstm_proj_f32"]
    got = fused_lstm.input_projection(xs, w_ih, b)
    again = fused_lstm.input_projection(
        xs, w_ih, b, fused_lstm.pack_proj_weights(w_ih, Fa))
    torch.cuda.synchronize()
    assert fused_lstm.launches["fused_bilstm_proj_f32"] == before + 2
    want = plain.input_projection(xs, w_ih, b)
    assert got.shape == want.shape == (T, 2, B, 4 * H)
    assert_close("xproj", got, want, REC_TOL[torch.float32])
    assert torch.equal(got, again)


@pytest.mark.parametrize("B", [4096, 1016])
@pytest.mark.parametrize("H", [128, 256])
def test_k1_plan_covers_the_rows_on_this_card(device, H, B):
    """K1's plan at call_mods' tiles: K1's wgmma recurrence at 4,096 rows,
    whose shared memory fits a block, and which agrees with the plain
    version in both output orders; the float32 cluster kernel at the
    1,016-row tail. On the cluster kernel (force_k1_rec) K1's
    recurrence stores K2's bits in K1's order; K2 (the training path)
    runs the cluster kernel and counts in its own counters."""
    kind, plan = k1_plan(H, B, device)
    assert kind == ("wgmma" if B == 4096 else "cluster")
    if kind == "wgmma":
        assert recurrence.k1w_smem(H, plan[1]) <= 232_448
    else:
        assert plan[0] == H // 32 and recurrence.recurrence_smem(
            0, H, plan[1], torch.float32) <= 232_448
    xproj, w_hh, _ = recurrence_inputs(H, B, torch.float32, device)
    before = dict(fused_lstm.launches)
    rbefore = dict(recurrence.launches)
    ys = recurrence.lstm_recurrence(xproj, w_hh, H)
    want = plain.lstm_recurrence(xproj, w_hh, H)
    for g, w in zip(plain.k1_outputs(ys, True), plain.k1_outputs(want, True)):
        assert_close("ys", g, w, REC_TOL[torch.float32])
    for seq_out in (True, False):
        got = recurrence.lstm_recurrence_k1(xproj, w_hh, H, seq_out,
                                            fused_lstm.launches)
        with recurrence.force_k1_rec("cluster"):
            on_cluster = recurrence.lstm_recurrence_k1(
                xproj, w_hh, H, seq_out, fused_lstm.launches)
        torch.cuda.synchronize()
        for g, c, k2, w in zip(got, on_cluster, plain.k1_outputs(ys, seq_out),
                               plain.k1_outputs(want, seq_out)):
            assert torch.equal(c, k2)
            assert_close("ys", g, w, REC_TOL[torch.float32])
    moved = {k: v - before[k] for k, v in fused_lstm.launches.items()}
    assert moved == {k: 2 * (k == K1_REC_COUNTERS[kind]) +
                     2 * (k == "fused_bilstm_rec_f32") for k in moved}
    assert {k: v - rbefore[k] for k, v in recurrence.launches.items()} == \
        {k: int(k == "lstm_recurrence_fwd_f32") for k in rbefore}


@pytest.mark.parametrize("seq_out", [True, False])
@pytest.mark.parametrize("B", [4096, 1016, 37])
@pytest.mark.parametrize("H", [128, 256])
def test_k1_wgmma_recurrence_matches_plain(device, monkeypatch, H, B,
                                           seq_out):
    """K1's wgmma recurrence (force_k1_rec("wgmma")) against the plain
    recurrence (ops/lstm.py) in K1's output order, within the float32
    route's tolerance, in clusters of 1, 2 and 4 blocks (the same bits:
    each block's sums do not depend on its cluster), over W_hh packed
    once or in the call (the same bits); each launch moves its own
    counter alone."""
    xproj, w_hh, _ = recurrence_inputs(H, B, torch.float32, device,
                                       seed=H + B)
    want = plain.k1_outputs(plain.lstm_recurrence(xproj, w_hh, H), seq_out)
    packed = fused_lstm.pack_rec_weights(w_hh)
    outs = []
    for C in (1, 2, 4):
        if C > -(-B // 64):
            continue
        monkeypatch.setattr(recurrence, "K1W_CLUSTERS", (C,))
        before = dict(fused_lstm.launches)
        with recurrence.force_k1_rec("wgmma"):
            assert recurrence.k1_rec_plan_on(device, B, H)[1][0] == C
            outs.append(recurrence.lstm_recurrence_k1(
                xproj, w_hh, H, seq_out, fused_lstm.launches,
                packed if C > 1 else None))
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in fused_lstm.launches.items()}
        assert moved == {k: int(k == "fused_bilstm_rec_f32_wgmma")
                         for k in moved}
        for g, w in zip(outs[-1], want):
            assert g.shape == w.shape == ((T if seq_out else 1), B, H)
            assert_close("ys", g, w, REC_TOL[torch.float32])
    for other in outs[1:]:
        for g, o in zip(outs[0], other):
            assert torch.equal(g, o)


def test_f32_forward_tile_takes_the_wgmma_recurrence(device):
    """A 4096-row float32 forward of the published both_bilstm (seeded
    weights) through the fused path: its three comb layers' recurrences
    on K1's wgmma recurrence (its counter 3, the cluster kernel's 0), the
    branches on the narrow kernel, and the probabilities within 1e-5 of
    the same forward with the recurrence on the cluster kernel."""
    from deepsignal_plant_tpu_torch.config import ModelConfig
    from deepsignal_plant_tpu_torch.models.bilstm import (
        Batch, ModelBiLSTM, init_params)
    cfg = ModelConfig(compute_dtype="float32", recurrence="kernel")
    model = ModelBiLSTM.from_params(init_params(cfg, 5), cfg, device)
    rng = np.random.default_rng(5)
    B, L = 4096, cfg.seq_len
    batch = Batch(
        torch.tensor(rng.integers(0, 4, (B, L)), device=device),
        *(torch.tensor(rng.normal(size=(B, L)), dtype=torch.float32,
                       device=device) for _ in range(2)),
        torch.tensor(rng.integers(1, 30, (B, L)), dtype=torch.float32,
                     device=device),
        torch.tensor(rng.normal(size=(B, L, cfg.signal_len)),
                     dtype=torch.float32, device=device))
    before = dict(fused_lstm.launches)
    with torch.no_grad():
        _, probs = model(batch)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in fused_lstm.launches.items()}
        with recurrence.force_k1_rec("cluster"):
            _, on_cluster = model(batch)
    assert moved["fused_bilstm_rec_f32_wgmma"] == 3
    assert moved["fused_bilstm_rec_f32"] == 0
    assert moved["fused_bilstm_f32_narrow"] == 2
    assert moved["fused_bilstm_proj_f32"] == 3
    assert (probs - on_cluster).abs().max().item() <= 1e-5


@pytest.mark.parametrize("B", [1016, 1, 37])
@pytest.mark.parametrize("layer", list(MAIN_PATH_LAYERS))
def test_bf16_kernel_at_partial_row_tiles(device, layer, B):
    """bfloat16 at the main path's five layers with fewer rows than one
    32-row block, and call_mods' ragged tail tile (1,016 rows)."""
    check_against_plain(*MAIN_PATH_LAYERS[layer], B, torch.bfloat16, device)


@pytest.mark.parametrize("seq_out", [True, False])
@pytest.mark.parametrize("Fa,Fb,H", [(512, 512, 512), (128, 0, 512)])
def test_bf16_kernel_at_the_widest_hidden_size(device, Fa, Fb, H, seq_out):
    """H=512, the wrapper's largest (eight 8-unit groups per warp), at
    a comb layer's 6 MB of weights a direction."""
    check_against_plain(Fa, Fb, H, seq_out, 100, torch.bfloat16, device)


def test_bf16_kernel_takes_packed_weights(device):
    """The packed weights a model caches give the same outputs as packing
    in the call, bit for bit, through the kernel the rule picks and
    through each kernel called directly; weights packed for the other
    kernel are refused."""
    xs, w_ih, b, w_hh = layer_inputs(256, 256, 256, 100, torch.bfloat16,
                                     device)
    assert fused_lstm.packed_for(512, 256, 100) == "wgmma"
    packs = {"wgmma": fused_lstm.pack_weights_wgmma(w_ih.float(),
                                                    w_hh.float()),
             "mma": fused_lstm.pack_weights(w_ih.float(), w_hh.float())}
    a = fused_lstm.bilstm_layer_fused(xs, w_ih, b, w_hh, 256)
    c = fused_lstm.bilstm_layer_fused(xs, w_ih.float(), b, w_hh.float(), 256,
                                      packed=packs["wgmma"])
    for g, w in zip(a, c):
        assert torch.equal(g, w)
    for kind in ("wgmma", "mma"):
        layer = F32_ROUTES[kind]
        a = layer(xs, w_ih, b, w_hh, 256)
        c = layer(xs, w_ih.float(), b, w_hh.float(), 256,
                  packed=packs[kind])
        for g, w in zip(a, c):
            assert torch.equal(g, w)
        with pytest.raises(ValueError):
            layer(xs, w_ih, b, w_hh, 256,
                  packed=packs["mma" if kind == "wgmma" else "wgmma"])


# the wgmma kernel (K1 bf16) at every main-path and denoise layer shape,
# rows below one 64-row block, one and two above it, call_mods' tail,
# --device_batch 3477 and a full tile
DENOISE_LAYERS = {"den_signal": (16, 0, 256, True),
                  "den_comb0": (256, 0, 256, True),
                  "den_comb1": (256, 256, 256, True)}


@pytest.mark.parametrize("seq_out", [True, False])
@pytest.mark.parametrize("B", [1, 63, 65, 1016, 3477, 4096])
@pytest.mark.parametrize("layer", list(MAIN_PATH_LAYERS)
                         + list(DENOISE_LAYERS))
def test_wgmma_kernel_matches_plain(device, layer, B, seq_out):
    Fa, Fb, H, _ = {**MAIN_PATH_LAYERS, **DENOISE_LAYERS}[layer]
    check_against_plain(Fa, Fb, H, seq_out, B, torch.bfloat16, device,
                        "wgmma")


@pytest.mark.parametrize("B", [200, 1016, 4096])
@pytest.mark.parametrize("layer", ["seq", "comb0", "comb1"])
def test_wgmma_rows_do_not_depend_on_the_cluster(device, layer, B):
    """The rows of a wide launch equal, bit for bit, those of 64-row
    launches (one block a direction) on the same rows, on the same design
    (a row's sums do not depend on how many blocks run or on any cluster:
    the kernel launches none), and are within the bound of the plain
    version."""
    Fa, Fb, H, seq_out = MAIN_PATH_LAYERS[layer]
    xs, w_ih, b, w_hh = layer_inputs(Fa, Fb, H, B, torch.bfloat16, device)
    assert fused_lstm.wgmma_plan(Fa + Fb, H, B) == \
        fused_lstm.wgmma_plan(Fa + Fb, H, 64)
    got = fused_lstm.layer_bf16_wgmma(xs, w_ih, b, w_hh, H, seq_out)
    want = bilstm_layer(xs, w_ih, b, w_hh, H, seq_out)
    for r0 in (0, 64):
        rows = tuple(x[:, r0:r0 + 64].contiguous() for x in xs)
        one = fused_lstm.layer_bf16_wgmma(rows, w_ih, b, w_hh, H, seq_out)
        for g, o in zip(got, one):
            assert torch.equal(g[:, r0:r0 + 64], o)
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max().item() <= \
            TOL[torch.bfloat16]


@pytest.mark.parametrize("B", [77, 1016, 4096])
@pytest.mark.parametrize("layer", ["seq", "signal"])
def test_streamed_design_matches_plain_at_the_branches(device, layer, B):
    """The streamed design, forced at the branch shapes the plan gives the
    resident design (its ring and x buffers at their widths), against the
    plain version, seq_out both ways."""
    Fa, Fb, H, _ = MAIN_PATH_LAYERS[layer]
    assert fused_lstm.wgmma_plan(Fa + Fb, H, B)[0] == fused_lstm.WG_RESIDENT
    plan = (fused_lstm.WG_STREAMED, fused_lstm.wgmma_stages(Fa + Fb, H), 2)
    xs, w_ih, b, w_hh = layer_inputs(Fa, Fb, H, B, torch.bfloat16, device)
    for seq_out in (True, False):
        got = fused_lstm._launch_wgmma(xs, w_ih, b, w_hh, H, seq_out, None,
                                       plan)
        want = bilstm_layer(xs, w_ih, b, w_hh, H, seq_out)
        for g, w in zip(got, want):
            assert (g.float() - w.float()).abs().max().item() <= \
                TOL[torch.bfloat16]


@pytest.mark.parametrize("B", [65, 4096])
@pytest.mark.parametrize("layer", list(MAIN_PATH_LAYERS))
def test_mma_kernel_matches_plain(device, layer, B):
    """The mma.sync kernel, called directly at the main path's shapes
    (the rule sends them to the wgmma kernel)."""
    check_against_plain(*MAIN_PATH_LAYERS[layer], B, torch.bfloat16, device,
                        "mma")


def test_wgmma_kernel_raises_on_what_it_does_not_take(device):
    """A launch the kernel refuses raises; nothing falls back."""
    S, R = fused_lstm.WG_STREAMED, fused_lstm.WG_RESIDENT
    xs, w_ih, b, w_hh = layer_inputs(16, 0, 128, 64, torch.bfloat16, device)
    before = dict(fused_lstm.launches)
    # plans the kernel refuses: a design it does not have, a ring of 1 or
    # 4 tiles, 3 x buffers
    for plan in ((2, 0, 0), (S, 1, 1), (S, 4, 1), (S, 2, 3)):
        with pytest.raises(RuntimeError):
            fused_lstm._launch_wgmma(xs, w_ih, b, w_hh, 128, True, None,
                                     plan)
    # at comb1 the plan is 3 ring tiles a warpgroup and one x buffer: two
    # x buffers outgrow a block's shared memory
    xs2, w_ih2, b2, w_hh2 = layer_inputs(512, 0, 256, 64, torch.bfloat16,
                                         device)
    assert fused_lstm.wgmma_plan(512, 256, 64) == (S, 3, 1)
    for plan in ((S, 3, 2),):
        with pytest.raises(RuntimeError):
            fused_lstm._launch_wgmma(xs2, w_ih2, b2, w_hh2, 256, True, None,
                                     plan)
    # the resident design takes F <= 32 and H <= 128 alone
    with pytest.raises(ValueError):        # its packing refuses F = 512
        fused_lstm._launch_wgmma(xs2, w_ih2, b2, w_hh2, 256, True, None,
                                 (R, 0, 0))
    xs3, w_ih3, b3, w_hh3 = layer_inputs(16, 0, 256, 64, torch.bfloat16,
                                         device)
    with pytest.raises(RuntimeError):      # H = 256: its weights do not fit
        fused_lstm._launch_wgmma(
            xs3, w_ih3, b3, w_hh3, 256, True,
            fused_lstm.pack_weights_resident(w_ih3, w_hh3), (R, 0, 0))
    xs, w_ih, b, w_hh = layer_inputs(16, 0, 512, 64, torch.bfloat16, device)
    with pytest.raises(ValueError):        # H > 256 does not fit
        fused_lstm.layer_bf16_wgmma(xs, w_ih, b, w_hh, 512)
    assert fused_lstm.launches == before


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


# ---------------------------------------------------------------------------
# the trainable recurrence (K2, K3, K4, dW_hh)

REC_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DW_TOL = 1e-5
# hidden sizes of the training path's five layers at batch 512: seq and
# signal H=128, comb H=256
TRAIN_H = [128, 256]


def recurrence_inputs(H, B, dtype, device, seed=0, steps=T):
    """xproj ~ N(0, 1) (a layer's projected inputs), w_hh ~ U(-1/sqrt(H),
    1/sqrt(H)) (torch's LSTM init), dys ~ N(0, 1) (a cotangent)."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)

    def dev(a, dt=dtype):
        return torch.tensor(a, dtype=torch.float32).to(device, dt)

    return (dev(rng.normal(size=(steps, 2, B, 4 * H))),
            dev(rng.uniform(-k, k, (2, H, 4 * H))),
            dev(rng.normal(size=(steps, 2, B, H))))


def assert_close(name, got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert torch.isfinite(got.float()).all(), name
    err = (got.float() - want.float()).abs().max().item()
    bound = tol * max(1.0, want.float().abs().max().item())
    assert err <= bound, f"{name}: max |kernel - plain| {err} > {bound}"


REC_NAMES = ("lstm_recurrence_fwd", "lstm_recurrence_fwd_save",
             "lstm_recurrence_bwd")


def expected_launches(H, dtype, stream=False):
    """The counters one K2, K3, K4, dW_hh round moves: the cluster kernels
    at H = 128 and 256 (recurrence_plan's shape rule; float32's under
    ``<name>_f32``), the streaming kernels (``<name>_stream``,
    ``<name>_f32_stream``) elsewhere or when asked for."""
    stream = stream or H not in (128, 256)
    f32 = "_f32" if dtype == torch.float32 else ""
    want = {k: 0 for k in recurrence.launches}
    for name in REC_NAMES:
        want[name + f32 + ("_stream" if stream else "")] = 1
    want["lstm_dw_hh"] = 1
    return want


def check_recurrence(H, B, dtype, device, stream=False, steps=T):
    xproj, w_hh, dys = recurrence_inputs(H, B, dtype, device, steps=steps)
    before = dict(recurrence.launches)
    ys = recurrence.lstm_recurrence(xproj, w_hh, H, stream=stream)
    ys_s, cs, gates = recurrence.lstm_recurrence_fwd_save(xproj, w_hh, H,
                                                          stream=stream)
    torch.cuda.synchronize()
    want_ys, want_cs, want_g = plain.lstm_recurrence_fwd_save(xproj, w_hh, H)
    tol = REC_TOL[dtype]
    assert_close("K2 ys", ys, want_ys, tol)
    assert_close("K3 ys", ys_s, want_ys, tol)
    assert_close("K3 cs", cs, want_cs, tol)
    assert_close("K3 gates", gates, want_g, tol)
    # K4 on the plain residuals: both sides see identical inputs
    dx = recurrence.lstm_recurrence_bwd_dx(dys, want_cs, want_g, w_hh, H,
                                           stream=stream)
    torch.cuda.synchronize()
    want_dx = plain.lstm_recurrence_bwd_dx(dys, want_cs, want_g, w_hh, H)
    assert_close("K4 dxproj", dx, want_dx, tol)
    dw = recurrence.lstm_dw_hh(want_ys, want_dx)
    torch.cuda.synchronize()
    assert_close("K4 dW_hh", dw, plain.lstm_dw_hh(want_ys, want_dx), DW_TOL)
    assert {k: recurrence.launches[k] - before[k] for k in before} == \
        expected_launches(H, dtype, stream)
    return dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [512, 509])
@pytest.mark.parametrize("H", TRAIN_H)
def test_recurrence_kernels_match_plain(device, H, B, dtype):
    check_recurrence(H, B, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("H", [8, 20, 96])
def test_recurrence_kernels_match_plain_at_odd_widths(device, H, B, dtype):
    check_recurrence(H, B, dtype, device)


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


@DTYPES
@pytest.mark.parametrize("steps", [13, 1])
@pytest.mark.parametrize("B", [512, 509, 1, 37])
@pytest.mark.parametrize("H", TRAIN_H)
def test_cluster_kernels_match_plain(device, H, B, steps, dtype):
    """The cluster kernels (K2, K3, K4's recurrence; float32's in 3xTF32)
    at the training widths, full, ragged and tiny batches, T 13 and 1
    (the launch counters show that the cluster kernels ran)."""
    check_recurrence(H, B, dtype, device, steps=steps)


@DTYPES
@pytest.mark.parametrize("B", [512, 509])
@pytest.mark.parametrize("H", TRAIN_H)
def test_streaming_kernels_match_plain_at_the_training_widths(device, H, B,
                                                              dtype):
    """The streaming kernels, which the cluster kernels replace at these
    widths, stay right where they are asked for."""
    check_recurrence(H, B, dtype, device, stream=True)


@DTYPES
@pytest.mark.parametrize("B", [512, 509])
@pytest.mark.parametrize("H", TRAIN_H)
def test_cluster_bwd_is_bitwise_reproducible(device, H, B, dtype):
    """K4's cluster recurrence sums its C partial products in rank order:
    two launches on the same inputs give the same bits."""
    xproj, w_hh, dys = recurrence_inputs(H, B, dtype, device, seed=7)
    _, cs, gates = plain.lstm_recurrence_fwd_save(xproj, w_hh, H)
    name = "lstm_recurrence_bwd" + ("_f32" if dtype == torch.float32
                                    else "")
    before = recurrence.launches[name]
    first = recurrence.lstm_recurrence_bwd_dx(dys, cs, gates, w_hh, H)
    second = recurrence.lstm_recurrence_bwd_dx(dys, cs, gates, w_hh, H)
    torch.cuda.synchronize()
    assert recurrence.launches[name] == before + 2
    assert torch.equal(first, second)


@DTYPES
@pytest.mark.parametrize("H", TRAIN_H)
def test_cluster_kernels_read_inputs_off_16_byte_alignment(device, H,
                                                           dtype):
    """The cluster kernels read 16-byte vectors; inputs that start off a
    16-byte boundary (contiguous views one element into a buffer) give
    the same outputs as aligned ones."""
    B = 37
    xproj, w_hh, dys = recurrence_inputs(H, B, dtype, device)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    ys, cs, gates = recurrence.lstm_recurrence_fwd_save(xproj, w_hh, H)
    ys2, cs2, gates2 = recurrence.lstm_recurrence_fwd_save(
        shifted(xproj), shifted(w_hh), H)
    dx = recurrence.lstm_recurrence_bwd_dx(dys, cs, gates, w_hh, H)
    dx2 = recurrence.lstm_recurrence_bwd_dx(shifted(dys), shifted(cs),
                                            shifted(gates), shifted(w_hh), H)
    torch.cuda.synchronize()
    for a, b in ((ys, ys2), (cs, cs2), (gates, gates2), (dx, dx2)):
        assert torch.equal(a, b)


@DTYPES
@pytest.mark.parametrize("H", [64, 128, 192, 256, 320, 512])
def test_shape_rule_sides(device, H, dtype):
    """recurrence_plan's shape rule on either side of its boundaries:
    H = 128 and 256 take the cluster kernels, 64, 192, 320 and 512 the
    streaming ones; each right against the plain version."""
    check_recurrence(H, 37, dtype, device)


@DTYPES
@pytest.mark.parametrize("B", [512, 509])
@pytest.mark.parametrize("H", TRAIN_H)
def test_plan_fits_one_wave_on_this_card(device, H, B, dtype):
    """At the training shapes every cluster kernel gets a plan whose
    clusters the card holds at once (its occupancy query) in bfloat16,
    and in at most two waves in float32 (clusters of 8 blocks at H=256
    leave fewer clusters on the card than the grid needs)."""
    allowed = 1 if dtype == torch.bfloat16 else 2
    for name, kind in recurrence._KIND.items():
        def cap(C, rows):
            return recurrence.cluster_capacity(device.index or 0, kind, H,
                                               C, rows, dtype)
        plan = recurrence.recurrence_plan(kind, B, H, cap, dtype)
        assert plan is not None, name
        cluster, rows = plan
        assert cluster == H // (64 if dtype == torch.bfloat16 else 32)
        assert -(-2 * -(-B // rows) // cap(cluster, rows)) <= allowed, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("steps", [13, 1])
@pytest.mark.parametrize("B", [512, 509])
@pytest.mark.parametrize("H", TRAIN_H)
def test_dw_hh_is_reproducible_and_matches_plain(device, H, B, steps, dtype):
    """The split-K dW_hh against the plain version, bitwise equal over two
    launches (fixed-order sum of the partials), and all zeros at T=1."""
    xproj, _, dys = recurrence_inputs(H, B, dtype, device, seed=5,
                                      steps=steps)
    ys, dx = dys, xproj                    # (T, 2, B, H), (T, 2, B, 4H)
    before = recurrence.launches["lstm_dw_hh"]
    first = recurrence.lstm_dw_hh(ys, dx)
    second = recurrence.lstm_dw_hh(ys, dx)
    torch.cuda.synchronize()
    assert recurrence.launches["lstm_dw_hh"] == before + 2
    assert torch.equal(first, second)
    assert_close("dW_hh", first, plain.lstm_dw_hh(ys, dx), DW_TOL)
    if steps == 1:
        assert not first.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_autograd_function_matches_plain_autograd(device, dtype):
    """BiLSTMRecurrence (K3 forward, K4 backward) against autograd through
    the plain loop: the gradients of one loss."""
    H, B = 128, 77
    xproj, w_hh, dys = recurrence_inputs(H, B, dtype, device, seed=3)
    grads = []
    for fn in (recurrence.bilstm_recurrence_trainable,
               plain.lstm_recurrence):
        xp = xproj.clone().requires_grad_(True)
        w = w_hh.clone().requires_grad_(True)
        (fn(xp, w, H).float() * dys.float()).sum().backward()
        grads.append((xp.grad, w.grad))
    (gx, gw), (px, pw) = grads
    assert gx.dtype == gw.dtype == dtype
    assert_close("dxproj", gx, px, REC_TOL[dtype])
    # the loss's dW sums bf16-rounded da's whose roundings may differ
    assert_close("dW_hh", gw, pw, REC_TOL[dtype])


def test_recurrence_kernels_reject_what_they_do_not_take(device):
    xproj, w_hh, _ = recurrence_inputs(16, 8, torch.float32, device)
    with pytest.raises(ValueError):        # w_hh of another dtype
        recurrence.lstm_recurrence(xproj, w_hh.bfloat16(), 16)
    with pytest.raises(TypeError):         # float16 is not a storage type
        recurrence.lstm_recurrence(xproj.half(), w_hh.half(), 16)
    with pytest.raises(ValueError):        # non-contiguous xproj
        recurrence.lstm_recurrence(xproj.transpose(0, 2), w_hh, 16)


@pytest.fixture
def dense_call_inputs(tmp_path):
    """A full-width bf16 checkpoint and a read-structured TSV of 20,000
    rows (call_mods_ab.py's dense writer): batches of 8,192 and a tail."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import call_mods_ab
    from deepsignal_plant_tpu_torch.config import ModelConfig
    from deepsignal_plant_tpu_torch.models.bilstm import init_params
    from deepsignal_plant_tpu_torch.models.convert import save_checkpoint
    cfg = ModelConfig(dropout_rate=0.0, compute_dtype="bfloat16")
    ckpt = str(tmp_path / "m.ckpt.npz")
    save_checkpoint(ckpt, init_params(cfg, 3), cfg)
    tsv = str(tmp_path / "dense.tsv")
    call_mods_ab.write_dense_features(tsv, 20_000, 11)
    return cfg, ckpt, tsv


def test_two_replicas_on_one_card_write_one_replicas_bytes(
        device, dense_call_inputs, tmp_path):
    from deepsignal_plant_tpu_torch.config import CallConfig
    from deepsignal_plant_tpu_torch.pipeline.call_mods import CallModsEngine
    cfg, ckpt, tsv = dense_call_inputs
    card = torch.device("cuda", 0)
    outs = {}
    for k in (1, 2):
        eng = CallModsEngine(ckpt, cfg, CallConfig(device_batch=8192),
                             [card] * k)
        before = dict(fused_lstm.launches)
        st = eng.run_features_file(tsv, str(tmp_path / f"{k}.tsv"))
        moved = {n: v - before[n] for n, v in fused_lstm.launches.items()}
        assert moved == {n: (5 * st.forward_tiles
                             if n == "fused_bilstm_bf16_wgmma" else 0)
                         for n in moved}
        # a full batch: two tiles, or two shares of one tile; the
        # 3,616-row tail: one tile, in the first share only
        assert st.forward_tiles == 5
        assert len(st.forward_device_seconds_per_card) == k
        outs[k] = (tmp_path / f"{k}.tsv").read_bytes()
    assert outs[1] == outs[2] and outs[1].count(b"\n") == 20_000


def test_call_mods_over_every_card_writes_one_cards_bytes(
        device, dense_call_inputs, tmp_path, capsys):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more visible cards")
    import json
    from deepsignal_plant_tpu_torch import cli
    _, ckpt, tsv = dense_call_inputs
    outs = {}
    for label, extra in (("every", []), ("one", ["--device", "cuda:0"])):
        out = tmp_path / f"{label}.tsv"
        cli.main(["call_mods", "-i", tsv, "-m", ckpt, "-o", str(out),
                  "--device_batch", "8192", "--verbose_stages", *extra])
        st = json.loads(next(ln for ln in capsys.readouterr().out
                             .splitlines() if ln.startswith("[stages] "))[9:])
        want = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                if label == "every" else ["cuda:0"])
        assert st["devices"] == want
        assert st["kernel_launches"]["fused_bilstm_bf16_wgmma"] == \
            5 * st["forward_tiles"]
        outs[label] = out.read_bytes()
    assert outs["every"] == outs["one"]
