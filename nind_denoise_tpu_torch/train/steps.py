"""Generator train and eval steps on an ``nn.Module``: the counterparts of
``nind_denoise_tpu/train/steps.py:38-237``.

The reference's Generator (nn_common.py:163-272): AMSGrad with betas
(beta1, 0.999) (``train/optim.AmsGrad``, which updates as optax does), a
weighted loss over {SSIM, L1, MSE, MSSSIM} on ``loss_cs`` centre crops of
the forward clipped to [0, 1], and a manual multiplicative LR decay. The
discriminator terms D1/D2 are not ported (ROADMAP item 6.2).

Steps run in float32 with TF32 off for cuDNN and matmuls, the precision
of the JAX reference on the CPU. A train step returns its metrics as 0-d
device tensors and never reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..engine.tile_engine import _tf32
from ..ops import losses as L
from .optim import AmsGrad

LOSS_NAMES = ("SSIM", "L1", "MSE", "MSSSIM", "D1", "D2")


def center_crop(batch_nchw: torch.Tensor, cs: int) -> torch.Tensor:
    """pt_ops.pt_crop_batch equivalent (NCHW)."""
    y0 = (batch_nchw.shape[2] - cs) // 2
    x0 = (batch_nchw.shape[3] - cs) // 2
    return batch_nchw[:, :, y0:y0 + cs, x0:x0 + cs]


def normalize_weights(weights: Dict[str, float]) -> Dict[str, float]:
    """get_weights semantics (nn_common.py:423-452): normalize to sum 1;
    all-zero -> MSSSIM=1 default."""
    w = {k: float(weights.get(k, 0.0)) for k in LOSS_NAMES}
    total = sum(w.values())
    if total == 0:
        w["MSSSIM"] = 1.0
    elif total != 1:
        w = {k: v / total for k, v in w.items()}
    return w


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt: AmsGrad


def make_optimizer(model: nn.Module, lr: float, beta1: float) -> AmsGrad:
    """AMSGrad with a run-time learning rate, as optax's
    ``inject_hyperparams(amsgrad)(learning_rate=lr, b1=beta1, b2=0.999)``."""
    return AmsGrad(model.parameters(), lr, b1=beta1, b2=0.999)


def get_lr(state: TrainState) -> float:
    return state.opt.hyper["learning_rate"]


def set_lr(state: TrainState, lr: float) -> TrainState:
    state.opt.set_hyper(learning_rate=lr)
    return state


def decay_lr(state: TrainState, factor: float) -> Tuple[TrainState, float]:
    """update_learning_rate parity: lr *= factor."""
    lr = get_lr(state) * factor
    return set_lr(state, lr), lr


def _quality_losses(gen_c, clean_c, weights, compute_ssim_anyway=False):
    metrics = {}
    total = 0.0
    if weights["SSIM"] > 0 or compute_ssim_anyway:
        metrics["SSIM"] = L.ssim_loss(gen_c, clean_c).mean()
        total += weights["SSIM"] * metrics["SSIM"]
    if weights["MSSSIM"] > 0:
        metrics["MSSSIM"] = L.ms_ssim_loss(gen_c, clean_c).mean()
        total += weights["MSSSIM"] * metrics["MSSSIM"]
    if weights["L1"] > 0:
        metrics["L1"] = L.l1_loss(gen_c, clean_c).mean()
        total += weights["L1"] * metrics["L1"]
    if weights["MSE"] > 0:
        metrics["MSE"] = L.mse_loss(gen_c, clean_c).mean()
        total += weights["MSE"] * metrics["MSE"]
    return total, metrics


def plain_apply(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return model(x)


def bf16_apply(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Mixed precision as the JAX trainer's ``--compute_dtype bfloat16``:
    the parameters and the input are cast to bf16 inside the
    differentiated function, the output back to fp32, so the master
    weights, the gradients, the optimizer and the loss stay fp32."""
    params = {k: v.to(torch.bfloat16) for k, v in model.named_parameters()}
    out = torch.func.functional_call(model, params, (x.to(torch.bfloat16),))
    return out.float()


def make_generator_train_step(apply_fn: Callable, weights: Dict[str, float],
                              loss_cs: int, compute_ssim_anyway: bool = False,
                              remat: bool = False, grad_accum: int = 1):
    """Returns ``step(state, clean, noisy) -> metrics`` on NCHW device
    tensors; it updates ``state.model`` in place. ``apply_fn(model, x)``
    is the forward (``plain_apply`` or ``bf16_apply``); ``remat``
    recomputes it in the backward (``torch.utils.checkpoint``).

    ``grad_accum=N`` (N must divide the batch) runs N contiguous
    microbatches, sums their gradients, scales the sum by 1/N and applies
    one update: for UtNet the full-batch step up to fp32 reassociation."""
    weights = normalize_weights(weights)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def fwd(model, x):
        if remat:
            return checkpoint(apply_fn, model, x, use_reentrant=False)
        return apply_fn(model, x)

    def loss_and_grad(model, clean, noisy):
        gen = torch.clamp(fwd(model, noisy), 0.0, 1.0)
        total, metrics = _quality_losses(center_crop(gen, loss_cs),
                                         center_crop(clean, loss_cs),
                                         weights, compute_ssim_anyway)
        total.backward()
        metrics["weighted"] = total
        return {k: v.detach() for k, v in metrics.items()}

    def step(state: TrainState, clean: torch.Tensor, noisy: torch.Tensor):
        model, opt = state.model, state.opt
        opt.zero_grad(set_to_none=True)
        with _tf32(False):
            if grad_accum == 1:
                metrics = loss_and_grad(model, clean, noisy)
            else:
                b = clean.shape[0]
                if b % grad_accum:
                    raise ValueError(f"grad_accum={grad_accum} must divide "
                                     f"the batch size {b}")
                mb = b // grad_accum
                sums: Dict[str, torch.Tensor] = {}
                for i in range(grad_accum):
                    m = loss_and_grad(model, clean[i * mb:(i + 1) * mb],
                                      noisy[i * mb:(i + 1) * mb])
                    sums = {k: sums[k] + v for k, v in m.items()} if sums else m
                inv = 1.0 / grad_accum
                torch._foreach_mul_([p.grad for p in opt.params], inv)
                metrics = {k: v * inv for k, v in sums.items()}
            opt.step()
        return metrics

    return step


def make_generator_eval_step(apply_fn: Callable, weights: Dict[str, float],
                             loss_cs: int, compute_ssim_anyway: bool = False):
    """Validation step -> weighted loss + components (validate_generator
    parity, nn_train.py:51-71). No autograd, so UtNet's level 1 takes the
    fused enc1 kernel on the card where its gate allows."""
    weights = normalize_weights(weights)

    @torch.no_grad()
    def step(model: nn.Module, clean: torch.Tensor, noisy: torch.Tensor):
        with _tf32(False):
            gen = torch.clamp(apply_fn(model, noisy), 0.0, 1.0)
            total, metrics = _quality_losses(center_crop(gen, loss_cs),
                                             center_crop(clean, loss_cs),
                                             weights, compute_ssim_anyway)
        metrics["weighted"] = total
        return metrics

    return step
