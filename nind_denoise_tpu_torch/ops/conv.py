"""Small NCHW tensor ops of the UtNet forward: the counterparts of
``nind_denoise_tpu/ops/conv.py``'s ``reflect_pad``, ``maxpool2x``,
``avgpool2x_ceil``, ``crop2`` and ``apply_activation`` (which work on NHWC
there)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """torch ReflectionPad2d (no edge duplication) on NCHW."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool, VALID (floors odd dims)."""
    return F.max_pool2d(x, 2)


def avgpool2x_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pool with ceil_mode (MS-SSIM's downsampling):
    an edge window of an odd side averages over its valid elements only."""
    return F.avg_pool2d(x, 2, ceil_mode=True)


def crop2(x: torch.Tensor, pad: int = 2) -> torch.Tensor:
    """ZeroPad2d(-pad): crop ``pad`` pixels from each spatial side."""
    if pad == 0:
        return x
    return x[:, :, pad:-pad, pad:-pad]


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """PReLU with one shared parameter: max(x, 0) + a * min(x, 0)."""
    return torch.where(x >= 0, x, a.to(x.dtype) * x)


def apply_activation(x: torch.Tensor, name: str,
                     a: Optional[torch.Tensor] = None) -> torch.Tensor:
    if name == "PReLU":
        return prelu(x, a)
    if name == "ELU":
        return F.elu(x)
    if name == "Hardswish":
        return F.hardswish(x)
    raise ValueError(f"unknown activation: {name}")
