"""Image quality losses on NCHW tensors: SSIM, MS-SSIM, L1/MSE, PSNR.

The counterparts of ``nind_denoise_tpu/ops/losses.py`` (NHWC there), with
the reference's semantics (pt_losses.SSIM_loss / MS_SSIM_loss wrap piqa
with ``reduction=None`` and return ``1 - metric`` per sample):

* Gaussian window 11, sigma 1.5, normalized; separable depthwise VALID
  convolutions (no padding), both passes in float32; value_range 1.0,
  k1 = 0.01, k2 = 0.03.
* MS-SSIM: 5 scales with weights (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
  2x average-pool downsampling with ceil_mode between scales, relu-clamped
  cs/ss, product of powers, mean over channels. Minimum input size 162.
  A scale whose ``cs`` is negative is relu'd to 0, and the product's
  gradient is then 0, not NaN: relu's backward selects 0 where its input
  is not positive, whatever ``0 ** (w - 1)`` gave above it.

All functions are per-sample (reduction=None); ``.mean()`` for a scalar.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .conv import avgpool2x_ceil

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
MS_SSIM_MIN_SIZE = 162


def gaussian_kernel(size: int = 11, sigma: float = 1.5,
                    device=None) -> torch.Tensor:
    half = (size - 1) / 2
    x = torch.arange(size, dtype=torch.float32, device=device) - half
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _depthwise_sep_conv(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable depthwise VALID conv of NCHW x with a 1D kernel (both axes)."""
    c, n = x.shape[1], k1d.numel()
    x = F.conv2d(x, k1d.view(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    return F.conv2d(x, k1d.view(1, 1, 1, n).expand(c, 1, 1, n), groups=c)


def ssim_per_channel(x: torch.Tensor, y: torch.Tensor, window_size: int = 11,
                     sigma: float = 1.5, value_range: float = 1.0,
                     k1: float = 0.01, k2: float = 0.03
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ssim, cs), each (N, C): spatial means per sample/channel."""
    x = x.float()
    y = y.float()
    c1 = (k1 * value_range) ** 2
    c2 = (k2 * value_range) ** 2
    k = gaussian_kernel(window_size, sigma, x.device)
    mu_x = _depthwise_sep_conv(x, k)
    mu_y = _depthwise_sep_conv(y, k)
    mu_xx = _depthwise_sep_conv(x * x, k)
    mu_yy = _depthwise_sep_conv(y * y, k)
    mu_xy = _depthwise_sep_conv(x * y, k)
    var_x = mu_xx - mu_x * mu_x
    var_y = mu_yy - mu_y * mu_y
    cov = mu_xy - mu_x * mu_y
    cs_map = (2 * cov + c2) / (var_x + var_y + c2)
    ss_map = (2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1) * cs_map
    return ss_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def ssim(x: torch.Tensor, y: torch.Tensor, **kwargs) -> torch.Tensor:
    """(N,) per-sample SSIM (mean over channels)."""
    ss, _ = ssim_per_channel(x, y, **kwargs)
    return ss.mean(dim=-1)


@functools.lru_cache(maxsize=None)
def _scale_weights(weights: tuple, device: torch.device) -> torch.Tensor:
    """The scale weights as a float32 tensor on ``device``, uploaded once:
    a train step then copies nothing from the host."""
    return torch.tensor(weights, dtype=torch.float32, device=device)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, weights=MS_SSIM_WEIGHTS,
            **kwargs) -> torch.Tensor:
    """(N,) per-sample MS-SSIM."""
    return ssim_and_ms_ssim(x, y, weights, **kwargs)[1]


def ssim_and_ms_ssim(x: torch.Tensor, y: torch.Tensor, weights=MS_SSIM_WEIGHTS,
                     **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """((N,) SSIM, (N,) MS-SSIM): MS-SSIM's first scale is SSIM's own
    computation, so both come from one pass, each equal to its function's."""
    if min(x.shape[2], x.shape[3]) < MS_SSIM_MIN_SIZE:
        raise ValueError(
            f"ms_ssim needs inputs >= {MS_SSIM_MIN_SIZE} px per side "
            f"(got {x.shape[2]}x{x.shape[3]}): the 5-scale pyramid's 11-tap "
            f"VALID windows run out of pixels below that")
    w = _scale_weights(tuple(weights), x.device)
    css = []
    ss = ssim0 = None
    for i in range(len(weights)):
        if i > 0:
            x = avgpool2x_ceil(x)
            y = avgpool2x_ceil(y)
        ss, cs = ssim_per_channel(x, y, **kwargs)
        if i == 0:
            ssim0 = ss.mean(dim=-1)
        css.append(torch.relu(cs))
    stack = torch.stack(css[:-1] + [torch.relu(ss)], dim=-1)  # (N, C, S)
    msss = torch.prod(stack ** w, dim=-1)
    return ssim0, msss.mean(dim=-1)


def ssim_loss(x, y, **kwargs):
    """1 - SSIM per sample (reference SSIM_loss semantics)."""
    return 1.0 - ssim(x, y, **kwargs)


def ms_ssim_loss(x, y, **kwargs):
    """1 - MS-SSIM per sample (reference MS_SSIM_loss semantics)."""
    return 1.0 - ms_ssim(x, y, **kwargs)


def mse_loss(x, y):
    return torch.mean((x.float() - y.float()) ** 2, dim=(1, 2, 3))


def l1_loss(x, y):
    return torch.mean(torch.abs(x.float() - y.float()), dim=(1, 2, 3))


def psnr(x, y, value_range: float = 1.0):
    m = mse_loss(x, y)
    return 10.0 * torch.log10(value_range ** 2 / m)
