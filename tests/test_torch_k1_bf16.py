"""K1 at bfloat16 (deepsignal_plant_tpu_torch.ops.fused_lstm): the wgmma
kernel's packed weights, its shape rule and the bfloat16 stack, on the
CPU. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py); here:

- pack_weights_wgmma (the streamed design's) and pack_weights_resident
  (the resident design's) unpack to (W_ih; W_hh) at every main-path and
  denoise (F, H) and at H 32 and 512, zero in their padding (the
  resident packing refuses F > 32);
- each packing read as the kernel reads it (the streamed one stage by
  stage in stream order, the resident one per warpgroup and chunk, x's
  K padded to 32; each tile unswizzled, the accumulator's columns mapped
  to (gate, unit) as its cell update maps them, h rounded to bf16 every
  step) computes the layer: against the plain version within 2e-2
  (tests/test_torch_fused_lstm.py's bfloat16 bound: both round h to bf16
  every step; only the sums' order differs);
- k1_bf16_plan's choice at every shape the main paths launch, against
  a hand-written table, its shared memory, and the L2 bytes by design,
  counted by hand;
- the CPU path launches no kernel, and the bfloat16 stack matches the
  JAX fused stack (Pallas in interpret mode) within 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsignal_plant_tpu.ops.pallas_fused import \
    bilstm_stack_fused_tm as jax_stack
from deepsignal_plant_tpu_torch.models.bilstm import BiLSTMLayer
from deepsignal_plant_tpu_torch.ops import fused_lstm
from deepsignal_plant_tpu_torch.ops.lstm import bilstm_layer

BF16_TOL = 2e-2

# (F, H) of the main path's layers (seq, signal, comb0, comb1-2), of
# denoise's signal_bilstm (signal branch, comb0, comb1-2), and H 32, 512
PACK_SHAPES = [(7, 128), (16, 128), (256, 256), (512, 256), (16, 256),
               (7, 32), (130, 32), (128, 512), (5, 12), (24, 96)]


def make_weights(seed, F, H):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    return (torch.from_numpy(rng.uniform(-k, k, (2, F, 4 * H))).float(),
            torch.from_numpy(rng.uniform(-k, k, (2, H, 4 * H))).float(),
            torch.from_numpy(rng.uniform(-k, k, (2, 4 * H))
                             + rng.uniform(-k, k, (2, 4 * H))).float())


def unswizzle_tiles(t, chunks):
    """Tiles (..., 128, 8 * chunks) read back from their swizzled image:
    element (n, k) sits at chunk (k // 8) ^ (n % 8) of row n (128-byte
    rows, 8 chunks) or (k // 8) ^ ((n // 2) % 4) (64-byte rows, 4)."""
    n = torch.arange(128).view(128, 1)
    c = torch.arange(chunks).view(1, chunks) ^ (
        n % 8 if chunks == 8 else (n // 2) % 4)
    t = t.float().reshape(*t.shape[:-1], chunks, 8)
    t = torch.gather(t, -2, c.view(128, chunks, 1).expand(128, chunks, 8)
                     .expand(t.shape))
    return t.reshape(*t.shape[:-2], 8 * chunks)


def unswizzle(packed, F, H):
    """The packed tiles as (2, nch, nkb, 2, 128, 64) float: stage (cc,
    kb) of each direction (K slabs in stream order: h's, then x's),
    warpgroup w's tile [n, k], its swizzle undone."""
    nkx, nch = fused_lstm.wgmma_dims(F, H)
    return unswizzle_tiles(packed.reshape(2, nch, nkx + nch, 2, 128, 64), 8)


def unswizzle_resident(packed, H):
    """The resident packing as (x tiles (2, 2, nch, 128, 32), h tiles (2,
    2, nch, nch, 128, 64)) float: per direction, warpgroup w and chunk
    cc, W_ih's tile [n, k] (64-byte swizzle undone) and W_hh's slab kb's
    tile [n, k] (128-byte swizzle undone)."""
    nch = -(-H // 64)
    kx = fused_lstm.RS_KX
    x = unswizzle_tiles(packed[..., :128 * kx].reshape(2, 2, nch, 128, kx),
                        4)
    h = unswizzle_tiles(packed[..., 128 * kx:].reshape(2, 2, nch, nch, 128,
                                                        64), 8)
    return x, h


def columns_to_gates(w, H):
    """(2, K, 2, nch, 128) packed columns (warpgroup, chunk, n = 32 ug + 8
    gate + e: gate ``gate`` of unit 32 (w nch + cc) + 8 ug + e) back to
    (2, K, 4, Hp) gate-major columns."""
    nch = w.shape[3]
    K = w.shape[1]
    w = w.reshape(2, K, 2, nch, 4, 4, 8).permute(0, 1, 5, 2, 3, 4, 6)
    return w.reshape(2, K, 4, 64 * nch)


def unpack_wgmma(packed, F, H):
    """pack_weights_wgmma's inverse: (w_ih (2, F, 4H), w_hh (2, H, 4H),
    the padded (2, Kx + Hp, 4, Hp) matrix in [x | h] rows and gate-major
    columns)."""
    nkx, nch = fused_lstm.wgmma_dims(F, H)
    Kx, Hp = 64 * nkx, 64 * nch
    t = unswizzle(packed, F, H)                   # (d, cc, kb, w, n, k)
    order = list(range(nkx, nkx + nch)) + list(range(nkx))
    w = torch.zeros(2, nkx + nch, 64, 2, nch, 128)
    w[:, order] = t.permute(0, 2, 5, 3, 1, 4)     # (d, kb, k, w, cc, n)
    # n = 32 ug + 8 gate + e; unit = 32 (w nch + cc) + 8 ug + e
    w = w.reshape(2, Kx + Hp, 2, nch, 4, 4, 8).permute(0, 1, 5, 2, 3, 4, 6)
    w = w.reshape(2, Kx + Hp, 4, Hp)
    return (w[:, :F, :, :H].reshape(2, F, 4 * H),
            w[:, Kx:Kx + H, :, :H].reshape(2, H, 4 * H), w)


@pytest.mark.parametrize("F,H", PACK_SHAPES)
def test_wgmma_packing_unpacks_to_the_weights(F, H):
    w_ih, w_hh, _ = make_weights(1, F, H)
    packed = fused_lstm.pack_weights_wgmma(w_ih, w_hh)
    nkx, nch = fused_lstm.wgmma_dims(F, H)
    assert (nkx, nch) == (-(-F // 64), -(-H // 64))
    assert packed.shape == (2, nch * (nkx + nch), 2, 128, 64)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    # one warpgroup's tile is the 16 KB its producer copies at once
    assert packed[0, 0, 0].numel() * 2 == fused_lstm.WG_TILE_BYTES
    got_ih, got_hh, full = unpack_wgmma(packed, F, H)
    assert torch.equal(got_ih, w_ih.bfloat16().float())
    assert torch.equal(got_hh, w_hh.bfloat16().float())
    Kx = 64 * nkx
    # zero past F, past H (rows and units)
    assert not full[:, F:Kx].any() and not full[:, Kx + H:].any()
    assert not full[:, :, :, H:].any()
    # stage 0 of direction 1 is chunk 0's first h slab: its warpgroup 0
    # tile, row n = 8 (unit-group 0, gate f, unit 0), k = 3 (h unit 3);
    # in the swizzle, 16-byte chunk 0 of row 8 sits at chunk 0 ^ 0 = 0
    assert packed[1, 0, 0, 8, 3] == w_hh[1, 3, H].bfloat16()


def emulate_wgmma(xs, packed, b, H, seq_out):
    """The wgmma kernel's arithmetic on its packed weights, as it reads
    them: per direction and step, A = [h slabs | x slabs] in stream
    order, each chunk's f32 products over the stages, accumulator column
    n of warpgroup w's chunk cc = gate (n % 32) // 8 of unit 32 * (w *
    nch + cc) + 8 * (n // 32) + n % 8, the cell update in f32, h rounded
    to bf16."""
    T, B = xs[0].shape[:2]
    F = sum(x.shape[-1] for x in xs)
    nkx, nch = fused_lstm.wgmma_dims(F, H)
    Kx, Hp = 64 * nkx, 64 * nch
    tiles = unswizzle(packed, F, H)
    x = torch.zeros(T, B, Kx)
    x[..., :F] = torch.cat([v.float() for v in xs], -1)
    bias = torch.zeros(2, 4, Hp)
    bias[:, :, :H] = b.float().reshape(2, 4, H)
    outs = []
    for d in range(2):
        h, c = torch.zeros(B, Hp), torch.zeros(B, Hp)
        ys = torch.zeros(T if seq_out else 1, B, H)
        for s in range(T):
            t = s if d == 0 else T - 1 - s
            slabs = ([h[:, 64 * j:64 * j + 64] for j in range(nch)]
                     + [x[t, :, 64 * j:64 * j + 64] for j in range(nkx)])
            h_new = torch.zeros(B, Hp)
            for w in range(2):
                for cc in range(nch):
                    acc = sum(a @ tiles[d, cc, kb, w].T
                              for kb, a in enumerate(slabs))   # (B, 128)
                    u0 = 32 * (w * nch + cc)
                    pre = acc.reshape(B, 4, 4, 8).permute(0, 2, 1, 3) \
                        .reshape(B, 4, 32) + bias[d, :, u0:u0 + 32]
                    i, f, o = (torch.sigmoid(pre[:, k]) for k in (0, 1, 3))
                    g = torch.tanh(pre[:, 2])
                    c[:, u0:u0 + 32] = f * c[:, u0:u0 + 32] + i * g
                    h_new[:, u0:u0 + 32] = (o * torch.tanh(
                        c[:, u0:u0 + 32])).bfloat16().float()
            h = h_new
            if seq_out:
                ys[t] = h[:, :H]
            elif s == T - 1:
                ys[0] = h[:, :H]
        outs.append(ys)
    return outs


@pytest.mark.parametrize("F,H", PACK_SHAPES)
def test_resident_packing_unpacks_to_the_weights(F, H):
    w_ih, w_hh, _ = make_weights(7, F, H)
    if F > fused_lstm.RS_KX:
        with pytest.raises(ValueError):
            fused_lstm.pack_weights_resident(w_ih, w_hh)
        return
    packed = fused_lstm.pack_weights_resident(w_ih, w_hh)
    nch = -(-H // 64)
    Hp, kx = 64 * nch, fused_lstm.RS_KX
    assert packed.shape == (2, 2, nch, 128 * kx + nch * 128 * 64)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    # a (warpgroup, chunk): W_ih's 8 KB tile and W_hh's 16 KB tiles
    assert packed[0, 0, 0].numel() * 2 == \
        fused_lstm.RS_XTILE_BYTES + nch * fused_lstm.WG_TILE_BYTES
    x, h = unswizzle_resident(packed, H)
    # (d, w, cc, n, k) -> (d, k, w, cc, n), then gate-major
    full_x = columns_to_gates(x.permute(0, 4, 1, 2, 3), H)
    full_h = columns_to_gates(h.permute(0, 3, 5, 1, 2, 4).reshape(
        2, Hp, 2, nch, 128), H)
    assert torch.equal(full_x[:, :F, :, :H].reshape(2, F, 4 * H),
                       w_ih.bfloat16().float())
    assert torch.equal(full_h[:, :H, :, :H].reshape(2, H, 4 * H),
                       w_hh.bfloat16().float())
    assert not full_x[:, F:].any() and not full_h[:, H:].any()
    assert not full_x[:, :, :, H:].any() and not full_h[:, :, :, H:].any()
    # direction 1, warpgroup 0, chunk 0: x tile row n = 8 (gate f of unit
    # 0), k = 3; in the 64-byte swizzle chunk 0 of row 8 sits at chunk 0 ^
    # (8 // 2) % 4 = 0
    if F > 3:
        assert packed[1, 0, 0, 8 * kx + 3] == w_ih[1, 3, H].bfloat16()


def emulate_resident(xs, packed, b, H, seq_out):
    """The resident design's arithmetic on its packed weights, as it reads
    them: per direction and step, per warpgroup w and chunk cc, x_t (K
    padded to 32) against W_ih's tile, then h_{t-1}'s slabs against W_hh's
    tiles, f32 sums; accumulator column n = gate (n % 32) // 8 of unit 32
    * (w * nch + cc) + 8 * (n // 32) + n % 8; the cell update in f32, h
    rounded to bf16."""
    T, B = xs[0].shape[:2]
    F = sum(x.shape[-1] for x in xs)
    nch = -(-H // 64)
    Hp, kx = 64 * nch, fused_lstm.RS_KX
    xt, ht = unswizzle_resident(packed, H)
    x = torch.zeros(T, B, kx)
    x[..., :F] = torch.cat([v.float() for v in xs], -1)
    bias = torch.zeros(2, 4, Hp)
    bias[:, :, :H] = b.float().reshape(2, 4, H)
    outs = []
    for d in range(2):
        h, c = torch.zeros(B, Hp), torch.zeros(B, Hp)
        ys = torch.zeros(T if seq_out else 1, B, H)
        for s in range(T):
            t = s if d == 0 else T - 1 - s
            h_new = torch.zeros(B, Hp)
            for w in range(2):
                for cc in range(nch):
                    acc = x[t] @ xt[d, w, cc].T + sum(
                        h[:, 64 * kb:64 * kb + 64] @ ht[d, w, cc, kb].T
                        for kb in range(nch))                  # (B, 128)
                    u0 = 32 * (w * nch + cc)
                    pre = acc.reshape(B, 4, 4, 8).permute(0, 2, 1, 3) \
                        .reshape(B, 4, 32) + bias[d, :, u0:u0 + 32]
                    i, f, o = (torch.sigmoid(pre[:, k]) for k in (0, 1, 3))
                    g = torch.tanh(pre[:, 2])
                    c[:, u0:u0 + 32] = f * c[:, u0:u0 + 32] + i * g
                    h_new[:, u0:u0 + 32] = (o * torch.tanh(
                        c[:, u0:u0 + 32])).bfloat16().float()
            h = h_new
            if seq_out:
                ys[t] = h[:, :H]
            elif s == T - 1:
                ys[0] = h[:, :H]
        outs.append(ys)
    return outs


# (B, T, input widths, H, seq_out) for the resident design
EMULATED_RESIDENT = {
    "seq": (5, 13, (7,), 128, True),
    "signal_final": (3, 13, (16,), 128, False),
    "odd_H": (4, 6, (7,), 20, True),
    "row_split_x32": (6, 5, (16, 16), 12, True),
}


@pytest.mark.parametrize("case", list(EMULATED_RESIDENT))
def test_the_kernels_reading_of_the_resident_packing_computes_the_layer(
        case):
    B, T, Fs, H, seq_out = EMULATED_RESIDENT[case]
    assert fused_lstm.wgmma_plan(sum(Fs), H, B)[0] == fused_lstm.WG_RESIDENT
    rng = np.random.default_rng(8)
    xs = tuple(torch.from_numpy(rng.normal(size=(T, B, F))).bfloat16()
               for F in Fs)
    w_ih, w_hh, b = make_weights(9, sum(Fs), H)
    packed = fused_lstm.pack_weights_resident(w_ih, w_hh)
    got = emulate_resident(xs, packed, b, H, seq_out)
    want = bilstm_layer(xs, w_ih.bfloat16(), b, w_hh.bfloat16(), H, seq_out)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = (g - w.float()).abs().max().item()
        assert err <= BF16_TOL, err


# (B, T, input widths, H, seq_out)
EMULATED = {
    "branch_odd_F": (5, 13, (7,), 32, True),
    "row_split": (4, 9, (64, 64), 64, True),
    "wide_final": (3, 6, (16,), 130, False),
    "odd_H_split": (6, 5, (5, 3), 12, True),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_the_kernels_reading_of_the_packing_computes_the_layer(case):
    B, T, Fs, H, seq_out = EMULATED[case]
    rng = np.random.default_rng(2)
    xs = tuple(torch.from_numpy(rng.normal(size=(T, B, F))).bfloat16()
               for F in Fs)
    w_ih, w_hh, b = make_weights(3, sum(Fs), H)
    packed = fused_lstm.pack_weights_wgmma(w_ih, w_hh)
    got = emulate_wgmma(xs, packed, b, H, seq_out)
    want = bilstm_layer(xs, w_ih.bfloat16(), b, w_hh.bfloat16(), H, seq_out)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = (g - w.float()).abs().max().item()
        assert err <= BF16_TOL, err


@pytest.mark.parametrize("F,H,stages", [
    (7, 128, 3), (16, 128, 3), (256, 256, 3), (512, 256, 3), (16, 256, 3),
    (1024, 128, 2), (1088, 128, 2), (1024, 256, 2), (1280, 128, 0),
    (1536, 256, 0), (2048, 64, 0), (512, 512, 0)])
def test_wgmma_stages_fit_a_blocks_shared_memory(F, H, stages):
    """Ring tiles a warpgroup of the streamed design: pairs of 16 KB
    tiles beside one x buffer (ceil(F/64) slabs of 8 KB), one h buffer
    (ceil(H/64) slabs), 12 barriers of 8 bytes and 1 KB of alignment,
    within 232,448 bytes; at most 3; 0 where two do not fit or H > 256."""
    assert fused_lstm.wgmma_stages(F, H) == stages
    if stages:
        nkx, nch = fused_lstm.wgmma_dims(F, H)
        fixed = (nkx + nch) * 8192 + 96 + 1024
        assert fixed + stages * 2 * 16384 <= 232_448
        assert stages == 3 or fixed + (stages + 1) * 2 * 16384 > 232_448


@pytest.mark.parametrize("H,smem", [(128, 205_832), (64, 74_760),
                                    (20, 74_760)])
def test_resident_design_fits_a_blocks_shared_memory(H, smem):
    """The resident design at H <= 128: a direction's weights (per
    warpgroup and chunk an 8 KB W_ih tile and 16 KB W_hh tiles: 160 KB at
    H = 128), two h buffers, two 4 KB x buffers, the barrier and 1 KB of
    alignment."""
    nch = -(-H // 64)
    assert fused_lstm.resident_smem(H) == smem == \
        2 * nch * (8192 + nch * 16384) + 2 * nch * 8192 + 2 * 4096 + 8 + 1024
    assert smem <= 232_448


# the layer shapes the main paths launch, by rows: call_mods' 4096-row
# tiles and 1,016-row tail, device_batch 3477, denoise's and training
# evaluation's 512-row tiles and tails (509, 93), a rank's 256 -> the
# wgmma kernel's (design, ring tiles, x buffers), the same at every row
# count (no clusters); None would be the mma.sync kernel
S, R = fused_lstm.WG_STREAMED, fused_lstm.WG_RESIDENT
MAIN_SHAPES = {(7, 128): (R, 0, 0), (16, 128): (R, 0, 0),
               (256, 256): (S, 3, 2), (512, 256): (S, 3, 1),
               (16, 256): (S, 3, 2)}
RULE = (4096, 1016, 3477, 512, 509, 256, 93, 64, 65, 1, 4200, 32768)


@pytest.mark.parametrize("B", RULE)
@pytest.mark.parametrize("F,H", list(MAIN_SHAPES))
def test_shape_rule_at_the_main_paths_shapes(F, H, B):
    assert fused_lstm.k1_bf16_plan(F, H, B) == MAIN_SHAPES[(F, H)]
    assert fused_lstm.packed_for(F, H, B) == (
        "resident" if MAIN_SHAPES[(F, H)][0] == R else "wgmma")


def test_mma_only_sends_every_layer_to_the_mma_kernel():
    with fused_lstm.mma_only():
        for F, H in MAIN_SHAPES:
            assert fused_lstm.k1_bf16_plan(F, H, 4096) is None
            assert fused_lstm.packed_for(F, H, 4096) == "mma"
            assert fused_lstm.wgmma_plan(F, H, 4096) is not None
    assert fused_lstm.k1_bf16_plan(512, 256, 4096) == (S, 3, 1)


@pytest.mark.parametrize("F,H,B,mma,wgmma", [
    # comb1 at a 4096-row tile: 128 blocks of 32 rows a direction read
    # 4 x 256 x 768 bf16 a step; 64 blocks of 64 rows a direction read
    # the same, streamed, once each a step
    (512, 256, 4096, 2 * 128 * 13 * 1024 * 768 * 2,
     2 * 64 * 13 * 1024 * 768 * 2),
    # the seq branch at the 1,016-row tail: K padded to 160; the resident
    # design's 16 blocks a direction read 512 x (32 + 128) once
    (7, 128, 1016, 2 * 32 * 13 * 512 * 160 * 2, 2 * 16 * 512 * 160 * 2),
    (16, 256, 64, 2 * 2 * 13 * 1024 * 288 * 2, 2 * 1 * 13 * 1024 * 320 * 2)])
def test_weight_l2_bytes_by_design(F, H, B, mma, wgmma):
    assert fused_lstm.weight_l2_bytes("mma", 13, F, H, B) == mma
    assert fused_lstm.weight_l2_bytes("wgmma", 13, F, H, B) == wgmma


@pytest.mark.parametrize("F,H", [(512, 512), (128, 512), (1536, 256),
                                 (64, 300)])
def test_shape_rule_sends_what_does_not_fit_to_the_mma_kernel(F, H):
    for B in (1, 512, 4096):
        assert fused_lstm.k1_bf16_plan(F, H, B) is None
        assert fused_lstm.packed_for(F, H, B) == "mma"


def test_cpu_path_launches_no_kernel():
    w_ih, w_hh, b = make_weights(4, 16, 32)
    x = (torch.zeros(13, 5, 16, dtype=torch.bfloat16),)
    before = dict(fused_lstm.launches)
    want = bilstm_layer(x, w_ih.bfloat16(), b, w_hh.bfloat16(), 32)
    for layer in (fused_lstm.bilstm_layer_fused, fused_lstm.layer_bf16_wgmma,
                  fused_lstm.layer_bf16_mma):
        got = layer(x, w_ih.bfloat16(), b, w_hh.bfloat16(), 32)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert fused_lstm.launches == before
    assert "fused_bilstm_bf16_wgmma" in fused_lstm.launches


def test_wgmma_packed_weights_cached_until_a_parameter_changes():
    w_ih, w_hh, b = make_weights(5, 16, 8)
    layer = BiLSTMLayer(16, 8)
    layer.load_state_dict({"w_ih": w_ih, "w_hh": w_hh, "b": b})
    first = fused_lstm.packed_weights(layer, "wgmma")
    mma = fused_lstm.packed_weights(layer, "mma")
    res = fused_lstm.packed_weights(layer, "resident")
    assert fused_lstm.packed_weights(layer, "wgmma") is first
    assert fused_lstm.packed_weights(layer, "mma") is mma
    assert fused_lstm.packed_weights(layer, "resident") is res
    assert torch.equal(first, fused_lstm.pack_weights_wgmma(w_ih, w_hh))
    assert torch.equal(res, fused_lstm.pack_weights_resident(w_ih, w_hh))
    with torch.no_grad():
        layer.w_hh.add_(0.5)
    second = fused_lstm.packed_weights(layer, "wgmma")
    assert second is not first
    assert fused_lstm.packed_weights(layer, "resident") is not res
    assert torch.equal(unpack_wgmma(second, 16, 8)[1],
                       (w_hh + 0.5).bfloat16().float())


def test_bf16_stack_matches_jax_fused_stack():
    """The signal_bilstm-like stack at bfloat16 (branch F=16, then two
    layers on (fwd, bwd) halves, top layer final states only): the
    port's stack on the CPU against JAX's fused stack, Pallas in
    interpret mode, within 2e-2."""
    B, T, F, H = 6, 13, 16, 8
    rng = np.random.default_rng(6)
    x = rng.normal(size=(T, B, F)).astype(np.float32)
    params, layers = [], []
    for i in range(3):
        w_ih, w_hh, b = make_weights(20 + i, F if i == 0 else 2 * H, H)
        params.append({"w_ih": w_ih.numpy(), "w_hh": w_hh.numpy(),
                       "b": b.numpy()})
        m = BiLSTMLayer(w_ih.shape[1], H)
        m.load_state_dict({"w_ih": w_ih, "w_hh": w_hh, "b": b})
        layers.append(m)
    with torch.no_grad():
        got = fused_lstm.bilstm_stack_fused_tm(
            torch.from_numpy(x), layers, H, compute_dtype=torch.bfloat16,
            last_layer_sequence=False)
    want = jax_stack(jnp.asarray(x, jnp.bfloat16),
                     [{k: jnp.asarray(v, jnp.bfloat16 if k != "b"
                                      else jnp.float32)
                       for k, v in p.items()} for p in params], H,
                     compute_dtype=jnp.bfloat16, last_layer_sequence=False,
                     block_b=8, interpret=True)
    for g, w in zip(got, want):
        assert g.shape == (1, B, H)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=BF16_TOL, rtol=0)
