"""The generator's training step, float32, plain PyTorch.

The reference trainer's step (github.com/trougnouf/nind-denoise,
nn_common.py Generator): the forward clipped to [0, 1], centre crops of
``loss_cs`` of it and of the clean batch, a weighted sum of MS-SSIM loss
(1 - MS-SSIM, piqa's definition) and MSE, the backward, and AMSGrad as
optax computes it (the maximum is taken of the bias-corrected second
moment). Written from those definitions; nothing here imports the
program.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import nets

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _window(device, dtype=torch.float32) -> torch.Tensor:
    x = torch.arange(11, dtype=dtype, device=device) - 5.0
    k = torch.exp(-(x * x) / (2 * 1.5 ** 2))
    return k / k.sum()


def _filter(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(c, 1, -1, 1).contiguous(), groups=c)
    return F.conv2d(x, k.view(1, 1, 1, -1).expand(c, 1, 1, -1).contiguous(), groups=c)


def _ssim_terms(x, y, k):
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = _filter(x, k), _filter(y, k)
    vx = _filter(x * x, k) - mx * mx
    vy = _filter(y * y, k) - my * my
    cov = _filter(x * y, k) - mx * my
    cs = (2 * cov + c2) / (vx + vy + c2)
    ss = (2 * mx * my + c1) / (mx * mx + my * my + c1) * cs
    return ss.mean(dim=(2, 3)), cs.mean(dim=(2, 3))


def ms_ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N,) MS-SSIM of NCHW images in [0, 1]."""
    k = _window(x.device, x.dtype)
    factors = []
    for i in range(len(MS_SSIM_WEIGHTS)):
        if i:
            x = F.avg_pool2d(x, 2, ceil_mode=True)
            y = F.avg_pool2d(y, 2, ceil_mode=True)
        ss, cs = _ssim_terms(x, y, k)
        factors.append(torch.relu(ss if i == len(MS_SSIM_WEIGHTS) - 1 else cs))
    w = torch.tensor(MS_SSIM_WEIGHTS, dtype=x.dtype, device=x.device)
    return torch.prod(torch.stack(factors, dim=-1) ** w, dim=-1).mean(dim=-1)


def centre(x: torch.Tensor, cs: int) -> torch.Tensor:
    y0, x0 = (x.shape[2] - cs) // 2, (x.shape[3] - cs) // 2
    return x[:, :, y0:y0 + cs, x0:x0 + cs]


def loss(gen: torch.Tensor, clean: torch.Tensor, weights: Dict[str, float],
         loss_cs: int) -> torch.Tensor:
    """The weighted loss (weights normalized to sum to 1)."""
    total_w = sum(weights.values())
    g, c = centre(torch.clamp(gen, 0.0, 1.0), loss_cs), centre(clean, loss_cs)
    out = torch.zeros((), dtype=gen.dtype, device=gen.device)
    for name, w in weights.items():
        if name == "MSSSIM":
            term = (1.0 - ms_ssim(g, c)).mean()
        elif name == "MSE":
            term = ((g - c) ** 2).mean(dim=(1, 2, 3)).mean()
        else:
            raise ValueError(f"no reference for the loss {name}")
        out = out + (w / total_w) * term
    return out


class AmsGrad:
    """optax's AMSGrad, one tensor at a time, float32 scalars."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.nu_max = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.mu[i] = self.b1 * self.mu[i] + (1.0 - self.b1) * g
            self.nu[i] = self.b2 * self.nu[i] + (1.0 - self.b2) * g * g
            self.nu_max[i] = torch.maximum(self.nu_max[i], self.nu[i] / c2)
            p -= self.lr * (self.mu[i] / c1) / (torch.sqrt(self.nu_max[i]) + self.eps)


def train_steps(network: str, weights_in: Dict[str, torch.Tensor], batches, opt_cfg: dict,
                loss_weights: Dict[str, float], loss_cs: int, ops: nets.Ops = nets.Ops(),
                dtype: torch.dtype = torch.float32):
    """Run len(batches) steps from ``weights_in`` (copied) on (clean,
    noisy) NCHW batches, all in ``dtype``. Returns (the losses, the first
    step's gradient as AMSGrad holds it (mu / (1 - b1)), the parameters
    after the last step), each leaf keyed by name."""
    params = {k: (v.detach().clone().to(dtype) if v.is_floating_point() else v.clone())
              for k, v in weights_in.items()}
    trainable = [k for k in params if is_param(k)]
    leaves = [params[k].requires_grad_() for k in trainable]
    opt = AmsGrad(leaves, opt_cfg["lr"], opt_cfg["beta1"])
    losses, grad1 = [], None
    for clean, noisy in batches:
        clean, noisy = clean.to(dtype), noisy.to(dtype)
        for p in leaves:
            p.grad = None
        out = nets.forward(network, params, noisy, train=True, ops=ops)
        total = loss(out, clean, loss_weights, loss_cs)
        total.backward()
        opt.step([p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves])
        losses.append(float(total.detach()))
        if grad1 is None:
            grad1 = {k: m / (1.0 - opt.b1) for k, m in zip(trainable, opt.mu)}
    return losses, grad1, {k: params[k].detach() for k in trainable}


def is_param(name: str) -> bool:
    """Whether a state-dict entry is a trained parameter (not a BatchNorm
    buffer)."""
    return not name.endswith(("running_mean", "running_var", "num_batches_tracked"))
