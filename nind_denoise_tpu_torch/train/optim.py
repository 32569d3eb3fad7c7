"""AMSGrad and Adam as optax computes them, as ``torch.optim.Optimizer``s.

The JAX trainer's optimizer is ``optax.inject_hyperparams(optax.amsgrad)``
(``nind_denoise_tpu/train/steps.py:65-69``). Its update, in its order,
with fp32 hyperparameters and eps_root 0:

    mu     <- b1 * mu + (1 - b1) * g
    nu     <- b2 * nu + (1 - b2) * g^2
    t      <- t + 1
    mu_hat  = mu / (1 - b1^t),   nu_hat = nu / (1 - b2^t)
    nu_max <- max(nu_max, nu_hat)
    p      <- p + (-lr) * mu_hat / (sqrt(nu_max + eps_root) + eps)

``torch.optim.Adam(amsgrad=True)`` is not this function: it keeps the
maximum of the raw second moment and divides by the current step's bias
correction afterwards, so the two part as soon as the second moment falls
(tests/test_torch_train_optim.py holds both against optax).

Every scalar is rounded to float32 on the host, as optax holds it, and
enters the kernels as a float32 operand; the bias corrections are
computed on the host from the step count, so a step never reads the
device. Each line of the update is one ``torch._foreach_*`` call over all
parameters. ``learning_rate`` is the hyperparameter that the trainer's
``set_lr``/``decay_lr`` change between steps.

``Adam`` is the discriminators' ``inject_hyperparams(optax.adam)``
(``nind_denoise_tpu/train/steps.py:65-69``, ``gan.py:72``): the same
update without ``nu_max``, dividing by ``sqrt(nu_hat + eps_root) + eps``.
``torch.optim.Adam`` is not it either: it folds the bias corrections into
the step size and the denominator, so it rounds otherwise.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

# optax's hyperparameter names, in the order its state flattens them
from ..models.params_io import OPT_HYPERPARAMS as HYPERPARAMS


def _f32(v) -> float:
    return float(np.float32(v))


class AmsGrad(torch.optim.Optimizer):
    """One parameter group. ``count`` is inject_hyperparams' step count and
    ``inner_count`` amsgrad's own; both advance once a step, and both are
    checkpointed, as optax keeps them. ``MOMENTS`` names the per-parameter
    state in optax's order."""

    MOMENTS = ("mu", "nu", "nu_max")

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        defaults = {k: _f32(v) for k, v in zip(
            HYPERPARAMS, (b1, b2, eps, eps_root, learning_rate))}
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("AmsGrad takes one parameter group")
        self.count = 0
        self.inner_count = 0

    @property
    def hyper(self) -> Dict[str, float]:
        return {k: self.param_groups[0][k] for k in HYPERPARAMS}

    def set_hyper(self, **values: float) -> None:
        for k, v in values.items():
            if k not in HYPERPARAMS:
                raise KeyError(k)
            self.param_groups[0][k] = _f32(v)

    @property
    def params(self) -> List[torch.Tensor]:
        return self.param_groups[0]["params"]

    def moments(self, name: str) -> List[torch.Tensor]:
        """One of ``MOMENTS`` for every parameter, in group order (zeros
        before the first step, as optax's init)."""
        out = []
        for p in self.params:
            st = self.state[p]
            if name not in st:
                st[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
            out.append(st[name])
        return out

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AmsGrad.step takes no closure")
        h = self.hyper
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        mu, nu = self.moments("mu"), self.moments("nu")
        b1, b2 = np.float32(h["b1"]), np.float32(h["b2"])
        one = np.float32(1)

        g1 = torch._foreach_mul(grads, float(one - b1))
        torch._foreach_mul_(mu, float(b1))
        torch._foreach_add_(mu, g1)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, float(one - b2))
        torch._foreach_mul_(nu, float(b2))
        torch._foreach_add_(nu, g2)

        self.count += 1
        self.inner_count += 1
        t = np.float32(self.inner_count)
        mu_hat = torch._foreach_div(mu, float(one - b1 ** t))
        nu_hat = torch._foreach_div(nu, float(one - b2 ** t))
        if "nu_max" in self.MOMENTS:
            nu_max = self.moments("nu_max")
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max

        den = torch._foreach_add(nu_hat, h["eps_root"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, h["eps"])
        torch._foreach_div_(mu_hat, den)
        torch._foreach_mul_(mu_hat, float(-np.float32(h["learning_rate"])))
        torch._foreach_add_(params, mu_hat)


class Adam(AmsGrad):
    """optax's Adam under ``inject_hyperparams``: AMSGrad's update with the
    bias-corrected second moment itself in the denominator."""

    MOMENTS = ("mu", "nu")
