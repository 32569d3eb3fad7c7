"""Normalization of the port's models: the counterpart of
``nind_denoise_tpu/models/norm.py``.

BatchNorm is ``nn.BatchNorm2d``: torch's semantics are the JAX package's
(the batch's statistics normalize in train mode with the biased variance,
the running stats take ``(1 - momentum) * old + momentum * batch`` with the
unbiased one; eval mode normalizes with the running stats). Each site keeps
its own eps and momentum (DnCNN's are 1e-4 and 0.95, the rest torch's
defaults, 1e-5 and 0.1). Instance norm is ``nn.InstanceNorm2d``'s defaults:
no affine parameters, no running stats.

``layer(m, x, frozen)`` runs one layer of a plain conv / activation / norm
stack. ``frozen=True`` is the cGAN's fooling term (a discriminator's
``pred_fn``): BatchNorm takes the batch's statistics in either mode and
changes no buffer, and every parameter is read detached, so no gradient
reaches the module, where the JAX package applies ``train=True`` and drops
the new state. Without ``frozen`` the layer is the module's own forward.
A module may bring its own statistics rule as a ``normalize`` method with
``F.batch_norm``'s arguments (``normalize_fn``): a data-parallel run's
``GlobalBatchNorm2d`` takes the global batch's, in its forward and in the
frozen path alike.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def detached(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach()


def normalize_fn(m: nn.BatchNorm2d) -> Callable[..., torch.Tensor]:
    """``m``'s batch-norm function, with ``F.batch_norm``'s arguments: its
    own ``normalize`` where it has one, else ``F.batch_norm``."""
    return getattr(m, "normalize", F.batch_norm)


def batch_norm(m: nn.BatchNorm2d, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
    """``m`` on ``x``; ``frozen``: the batch's statistics, no running-stat
    update, the affine parameters detached."""
    if not frozen:
        return m(x)
    return normalize_fn(m)(x, None, None, detached(m.weight), detached(m.bias), True, 0.0,
                           m.eps)


def layer(m: nn.Module, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
    """One layer of a Sequential stack (see the module doc)."""
    if not frozen:
        return m(x)
    if isinstance(m, nn.Conv2d):
        return F.conv2d(x, m.weight.detach(), detached(m.bias), m.stride, m.padding,
                        m.dilation, m.groups)
    if isinstance(m, nn.PReLU):
        return F.prelu(x, m.weight.detach())
    if isinstance(m, nn.BatchNorm2d):
        return batch_norm(m, x, True)
    if next(m.parameters(recurse=False), None) is not None:
        raise TypeError(f"no frozen forward for {type(m).__name__}")
    return m(x)  # activations, instance norm, pads: no parameters


def sequential(seq: nn.Sequential, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
    for m in seq:
        x = layer(m, x, frozen)
    return x


def norm_layer(norm_type: str, c: int) -> nn.Module:
    """The norm site of the pix2pix nets: ``batch`` (torch's defaults) or
    ``instance`` (affine-free, no running stats)."""
    if norm_type == "batch":
        return nn.BatchNorm2d(c)
    if norm_type == "instance":
        return nn.InstanceNorm2d(c)
    raise ValueError(f"unknown norm type {norm_type!r} (batch or instance)")
