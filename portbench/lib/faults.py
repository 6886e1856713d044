"""What the comparison has to catch, planted under a run: the control
(the plain reference in a lower precision, put in the program's place)
and the faults a call_mods cell can have. Each is a context manager
over the program's ``call_mods`` module, for ``calibrate.py`` and the
tests; ``run.py`` never plants one."""
from __future__ import annotations

import contextlib

import torch

from portbench.lib import weights
from portbench.reference import bilstm as reference


@contextlib.contextmanager
def _forward(fn):
    """Every forward of the engine through ``fn(forward, model, batch)``,
    ``forward`` the program's own."""
    from deepsignal_plant_tpu_torch.pipeline import call_mods
    saved = call_mods.forward_tiled
    call_mods.forward_tiled = lambda model, b: fn(saved, model, b)
    try:
        yield
    finally:
        call_mods.forward_tiled = saved


def control(cfg: dict, seed: int, device, precision: str):
    """The reference at ``precision`` (the state dict the run makes from
    ``seed``) in the program's place; the engine feeds and emits."""
    sd = weights.make(cfg, seed, device)

    def fn(forward, model, b):
        return reference.probs_in_blocks(
            sd, cfg, b.kmer, b.base_means, b.base_stds,
            b.base_signal_lens, b.signals, precision=precision)
    return _forward(fn)


def half_batch():
    """Half of each batch left out of the forward, the other half given
    the mean of the computed half's probabilities."""
    def fn(forward, model, b):
        n = b.kmer.shape[0]
        h = max(1, n // 2)
        probs = forward(model, type(b)(*(a[:h] for a in b)))
        rest = probs.mean(dim=0, keepdim=True).expand(n - h, -1)
        return torch.cat([probs, rest])
    return _forward(fn)


def altered_answer():
    """The first site of every batch called the other way."""
    def fn(forward, model, b):
        probs = forward(model, b).clone()
        probs[0] = probs[0].flip(0)
        return probs
    return _forward(fn)


@contextlib.contextmanager
def dropped_rows():
    """Every second row left out where the engine writes its rows."""
    from deepsignal_plant_tpu_torch.pipeline import call_mods
    base = call_mods.AsyncWriter

    class Dropping(base):
        def write(self, block: bytes):
            rows = block.split(b"\n")[:-1]
            super().write(b"".join(r + b"\n" for r in rows[::2]))
    call_mods.AsyncWriter = Dropping
    try:
        yield
    finally:
        call_mods.AsyncWriter = base
