"""Optimizers of the training loop (counterpart of
deepsignal_plant_tpu/ops/optim.py:1-122): the reference's four choices
(train.py:79-95) with optax's update rules, which differ from
``torch.optim``'s:

- Adam: optax.adam (b1 .9, b2 .999, eps 1e-8 outside the root);
- RMSprop: optax.rmsprop (decay .9, eps 1e-8 inside the root:
  g * rsqrt(nu + eps)); torch's RMSprop decays at .99, eps outside;
- SGD: optax.sgd with momentum .8 (trace = g + .8 * trace);
- Ranger: gradient centralization -> optax.radam (b1 .95, b2 .999,
  eps 1e-5, rectified from rho >= 5) -> Lookahead (k 6, alpha .5), as
  ranger2020.py composes them.

The learning rate of an update is ``schedule(count)`` at the count of
updates made before it, as optax evaluates a schedule. Every rule runs
elementwise on the float32 parameters in place. The step-count scalars
(bias corrections 1 - b**t, RAdam's rho and rectification) are computed
on the host in float32 in optax's order of operations: near t = 1 the
subtraction 1 - b**t cancels most of its digits, so float64 scalars
would move the updates away from the reference (by 2e-5 of the rate for
Adam, more for RAdam's rectification near its threshold).
"""
from __future__ import annotations

import numpy as np
import torch

OPTIM_TYPES = ("Adam", "RMSprop", "SGD", "Ranger")
#: each optimizer's state, one float32 tensor per parameter a slot, beside
#: the update count (optax's count, the schedule's argument)
STATE_SLOTS = {"Adam": ("mu", "nu"), "RMSprop": ("nu",), "SGD": ("trace",),
               "Ranger": ("mu", "nu", "slow")}


def step_decay_schedule(base_lr: float, steps_per_epoch: int,
                        decay_step_epochs: int, gamma: float):
    """StepLR (reference train.py:96): lr * gamma^(epoch // decay_step),
    with the epoch derived from the update count."""

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // decay_step_epochs)

    return schedule


class Optimizer:
    """One of OPTIM_TYPES over a list of parameters. ``step(grads)``
    updates the parameters in place with gradients in the same order."""

    def __init__(self, optim_type: str, schedule, params: list):
        if optim_type not in OPTIM_TYPES:
            raise ValueError("optim_type is not right!")
        self.optim_type = optim_type
        self.schedule = schedule
        self.params = list(params)
        self.count = 0

        def zeros():
            return [torch.zeros_like(p, dtype=torch.float32)
                    for p in self.params]

        if optim_type in ("Adam", "Ranger"):
            self.mu, self.nu = zeros(), zeros()
        elif optim_type == "RMSprop":
            self.nu = zeros()
        else:
            self.trace = zeros()
        if optim_type == "Ranger":
            self.slow = [p.detach().clone() for p in self.params]

    def state_arrays(self) -> dict:
        """The state as host arrays: ``count`` (an int64 scalar) and,
        per slot of STATE_SLOTS, a list of float32 arrays in the
        parameters' order."""
        out = {"count": np.asarray(self.count, np.int64)}
        for slot in STATE_SLOTS[self.optim_type]:
            out[slot] = [t.detach().cpu().numpy().copy()
                         for t in getattr(self, slot)]
        return out

    @torch.no_grad()
    def load_state_arrays(self, state: dict) -> None:
        """Restore ``state_arrays()``'s output (the same optimizer over
        parameters of the same shapes); the schedule then continues at
        the saved count."""
        slots = STATE_SLOTS[self.optim_type]
        if set(state) != {"count", *slots}:
            raise ValueError(f"{self.optim_type} state needs count and "
                             f"{slots}, got {sorted(state)}")
        for slot in slots:
            dst = getattr(self, slot)
            if len(state[slot]) != len(dst):
                raise ValueError(f"{slot}: {len(state[slot])} arrays for "
                                 f"{len(dst)} parameters")
            for t, a in zip(dst, state[slot]):
                if tuple(np.shape(a)) != tuple(t.shape):
                    raise ValueError(f"{slot}: shape {np.shape(a)} for a "
                                     f"parameter of {tuple(t.shape)}")
                t.copy_(torch.from_numpy(np.asarray(a, np.float32)))
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, grads: list) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        update = getattr(self, "_" + self.optim_type.lower())
        for i, (p, g) in enumerate(zip(self.params, grads)):
            update(i, p, g.float(), lr)

    def _adam(self, i, p, g, lr, b1=0.9, b2=0.999, eps=1e-8):
        mu = self.mu[i].copy_((1 - b1) * g + b1 * self.mu[i])
        nu = self.nu[i].copy_((1 - b2) * (g * g) + b2 * self.nu[i])
        u = (mu / _bias_correction(b1, self.count)) / (
            torch.sqrt(nu / _bias_correction(b2, self.count)) + eps)
        p.add_(-lr * u)

    def _rmsprop(self, i, p, g, lr, decay=0.9, eps=1e-8):
        nu = self.nu[i].copy_((1 - decay) * (g * g) + decay * self.nu[i])
        p.add_(-lr * (torch.rsqrt(nu + eps) * g))

    def _sgd(self, i, p, g, lr, momentum=0.8):
        tr = self.trace[i].copy_(g + momentum * self.trace[i])
        p.add_(-lr * tr)

    def _ranger(self, i, p, g, lr, b1=0.95, b2=0.999, eps=1e-5,
                threshold=5.0, k=6, alpha=0.5):
        t = self.count
        if g.dim() > 1:                      # gradient centralization
            g = g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
        mu = self.mu[i].copy_((1 - b1) * g + b1 * self.mu[i])
        nu = self.nu[i].copy_((1 - b2) * (g * g) + b2 * self.nu[i])
        mu_hat = mu / _bias_correction(b1, t)
        r = _radam_rectification(b2, t, threshold)
        if r is not None:
            u = r * mu_hat / (torch.sqrt(nu / _bias_correction(b2, t)) + eps)
        else:
            u = mu_hat
        u = -lr * u
        if t % k == 0:                       # lookahead: sync slow weights
            slow = self.slow[i]
            slow.copy_(slow + alpha * (p + u - slow))
            u = slow - p
        p.add_(u)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32 (optax's bias_correction)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _radam_rectification(b2: float, count: int, threshold: float):
    """optax.scale_by_radam's r in float32, or None below the threshold
    (the update is then the bias-corrected momentum alone)."""
    f = np.float32
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = f(b2) ** f(count)
    ro = f(ro_inf) - f(2 * count) * b2t / (f(1) - b2t)
    if not ro >= threshold:
        return None
    return float(np.sqrt((ro - f(4)) * (ro - f(2)) * f(ro_inf)
                         / (f((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
