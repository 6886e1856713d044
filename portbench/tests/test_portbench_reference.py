"""The plain reference against the program's CPU path (its plain
PyTorch versions of the kernels) at a small size, on the benchmark's own
weights and inputs; and its controls' lower precisions."""
import numpy as np
import pytest
import torch

from portbench.lib import spec, weights
from portbench.reference import bilstm as reference

CFG = spec.read_json(spec.BENCH_DIR, "configs",
                     "dp2_bilstm_b13s16_f32.json")


@pytest.fixture(scope="module")
def sites(tmp_path_factory):
    p = {**spec.read_json(spec.BENCH_DIR, "traffic",
                          "allc_tsv_262k.json"), "sites": 600}
    d = tmp_path_factory.mktemp("ref")
    inp = spec.load_module("traffic", p["kind"]).make(p, 23, str(d), 600)
    s = inp.sample
    return [torch.from_numpy(a) for a in (s.kmer, s.means, s.stds, s.lens,
                                          s.signals)]


def test_reference_matches_program_cpu_path(tmp_path, sites):
    from deepsignal_plant_tpu_torch.models.bilstm import Batch, ModelBiLSTM
    from deepsignal_plant_tpu_torch.models.convert import (
        load_any_checkpoint)
    from portbench.entries.call_mods import model_config
    sd = weights.make(CFG, 7, "cpu")
    ckpt = str(tmp_path / "m.ckpt")
    weights.save(sd, ckpt)
    cfg = model_config(CFG, torch.device("cpu"))
    model = ModelBiLSTM.from_params(load_any_checkpoint(ckpt, cfg), cfg,
                                    "cpu")
    with torch.inference_mode():
        _, got = model(Batch(*sites))
    _, want = reference.forward(sd, CFG, *sites)
    assert float((got - want).abs().max()) < 1e-5
    # the answers spread: a comparison can tell one site from another
    p1 = want[:, 1]
    assert float(p1.max() - p1.min()) > 0.05


@pytest.mark.parametrize("precision,low,high", [("tf32", 1e-5, 1e-2),
                                                ("fp8", 1e-3, 0.5)])
def test_controls_round_the_products(sites, precision, low, high):
    sd = weights.make(CFG, 8, "cpu")
    _, p32 = reference.forward(sd, CFG, *sites)
    _, pc = reference.forward(sd, CFG, *sites, precision=precision)
    gap = float((pc - p32)[:, 1].abs().max())
    assert low < gap < high


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -12)])
    r = reference._rounder("tf32")(x)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                          -(1.0 + 2 ** -10)]


def test_blocks_give_the_forward(sites):
    sd = weights.make(CFG, 9, "cpu")
    whole = reference.forward(sd, CFG, *sites)[1]
    blocks = reference.probs_in_blocks(sd, CFG, *sites, block=128)
    np.testing.assert_allclose(blocks.numpy(), whole.numpy(), atol=1e-6)
