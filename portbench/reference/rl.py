"""Richardson-Lucy deblur and the gmic quantize, float32, plain PyTorch.

The reference pipeline's ``gmic -deblur_richardsonlucy <sigma>,<iterations>,1
-/ 256 cut 0,255 round`` after the denoiser: a Gaussian point-spread
function truncated at radius ceil(3 sigma) and normalized, the image's
edge pixels replicated outward, ``u <- u * G*(d / max(G*u, 1e-8))`` from
``u = d = max(x, 0)``, then ``u * 65535 / 256`` cut to [0, 255] and
rounded half to even. The blur is one depthwise convolution a direction.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-8


def gaussian_taps(sigma: float, device=None) -> torch.Tensor:
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def blur(planes: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(P, H, W) -> (P, H, W): the separable blur, edges replicated."""
    r = (taps.numel() - 1) // 2
    x = planes[:, None]
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), taps.view(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), taps.view(1, 1, 1, -1))
    return x[:, 0]


def deblur(image: torch.Tensor, sigma: float, iterations: int) -> torch.Tensor:
    """(H, W, C) float32 -> (H, W, C) float32."""
    d = torch.clamp(image.permute(2, 0, 1).float(), min=0).contiguous()
    taps = gaussian_taps(sigma, d.device)
    u = d
    for _ in range(iterations):
        u = u * blur(d / torch.clamp(blur(u, taps), min=EPS), taps)
    return u.permute(1, 2, 0)


def quantize_u8(u: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(u * (65535.0 / 256.0), 0, 255)).to(torch.uint8)


def to_u8(canvas: torch.Tensor, sigma: float, iterations: int) -> torch.Tensor:
    """The denoised canvas -> the delivered uint8 image."""
    return quantize_u8(deblur(torch.clamp(canvas, min=0), sigma, iterations))
