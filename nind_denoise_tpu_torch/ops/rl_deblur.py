"""Richardson-Lucy deblur and the gmic quantize, on the device.

Counterpart of ``nind_denoise_tpu/ops/rl_deblur.py``: the reference
pipeline's ``gmic -deblur_richardsonlucy <sigma>,<iterations>,1 -/ 256
cut 0,255 round`` with the exact truncated-FIR Gaussian PSF (radius
ceil(3 sigma), normalized float32 taps), edge-replicate boundary, the
multiplicative iteration ``u <- u * G*(d / max(G*u, 1e-8))`` from
``d = max(x, 0)``, and the ``*65535/256, cut, round`` post-op to uint8.

The route is chosen from the PSF radius R = ceil(3 sigma) before any
launch (``route_for``), as the JAX package picks its fused kernel or its
XLA path:

- ``"fused"`` (R <= 32, the fused kernel's limit in both packages): one
  ``rl_fused.rl_iter`` launch an iteration (kernel K1);
- ``"separable_k3"`` (32 < R <= 64): the XLA path's body, blur, ratio,
  blur, product, with each blur one ``gauss_blur.blur_planes`` launch
  (kernel K3) over all planes and the ratio and product as torch ops;
- ``"separable_plain"`` (R > 64, sigma > 21.33): the same body with the
  tap-unrolled ``rl_fused.blur``, the counterpart of the JAX package's
  lax ``_blur``.

On the CPU every route runs the plain versions of its kernels, so all
three equal ``rl_fused.rl_iter_reference`` iterated, bit for bit.
``routes`` counts the calls per route. ``psf='gmic_fast'`` (the Deriche
IIR) and ``dt != 1`` are not ported yet and raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import gauss_blur, rl_fused

ROUTES = ("fused", "separable_k3", "separable_plain")
routes = dict.fromkeys(ROUTES, 0)


def psf_radius(sigma: float) -> int:
    return max(1, int(math.ceil(3.0 * sigma)))


def gaussian_taps_np(sigma: float) -> np.ndarray:
    """The canonical truncated-FIR Gaussian (radius ceil(3 sigma),
    normalized) as float32."""
    r = psf_radius(sigma)
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-(x ** 2) / np.float32(2.0 * sigma ** 2)).astype(np.float32)
    return k / k.sum()


def route_for(radius: int) -> str:
    """The RL route for PSF radius ``radius``; see the module doc."""
    if radius <= rl_fused.MAX_RADIUS:
        return "fused"
    if radius <= gauss_blur.MAX_RADIUS:
        return "separable_k3"
    return "separable_plain"


def rl_deblur(img: torch.Tensor, sigma: float = 1.0, iterations: int = 10,
              dt: float = 1.0, psf: str = "gaussian") -> torch.Tensor:
    """Richardson-Lucy deconvolution of (H, W, C) or (N, H, W, C); returns
    the same shape in float32. Planes are independent, so a batch member
    equals its single-image run bit for bit."""
    if psf not in ("gaussian", "gmic_fast"):
        raise ValueError(f"rl_deblur: unknown psf {psf!r}")
    if psf != "gaussian" or dt != 1.0:
        raise NotImplementedError(
            "rl_deblur: only psf='gaussian' with dt=1 is ported")
    if img.dim() not in (3, 4):
        raise ValueError(f"rl_deblur: need HWC or NHWC, got {tuple(img.shape)}")
    x = img[None] if img.dim() == 3 else img
    n, h, w, c = x.shape
    d = torch.clamp(x.permute(0, 3, 1, 2).reshape(n * c, h, w)
                    .to(torch.float32), min=0.0).contiguous()
    taps_np = gaussian_taps_np(sigma)
    taps = torch.from_numpy(taps_np).to(d.device)
    route = route_for(psf_radius(sigma))
    routes[route] += 1
    # two u buffers, swapped each iteration; d stays read-only
    bufs = ([torch.empty_like(d), torch.empty_like(d)]
            if d.device.type == "cuda" else [None, None])
    u = d
    if route == "fused":
        for i in range(int(iterations)):
            u = rl_fused.rl_iter(u, d, taps, out=bufs[i % 2])
    else:
        taps_list = taps_np.tolist()
        blur = (gauss_blur.blur_planes if route == "separable_k3"
                else lambda x, _: rl_fused.blur(x, taps_list))
        for i in range(int(iterations)):
            ratio = d / torch.clamp(blur(u, taps), min=rl_fused.EPS)
            u = torch.mul(u, blur(ratio, taps), out=bufs[i % 2])
    out = u.reshape(n, c, h, w).permute(0, 2, 3, 1)
    return out[0] if img.dim() == 3 else out


def gmic_quantize_u8(u: torch.Tensor) -> torch.Tensor:
    """gmic's ``*65535/256, cut 0-255, round`` -> uint8 (round half to
    even, as jnp.round)."""
    return torch.round(torch.clamp(u * (65535.0 / 256.0), 0, 255)).to(torch.uint8)


def rl_to_u8_device(img01: torch.Tensor, sigma: float = 1.0,
                    iterations: int = 10, psf: str = "gaussian") -> torch.Tensor:
    """RL deblur + gmic quantize on the tensor's device: [0, 1] HWC or
    NHWC in, uint8 of the same shape out. The input is clipped at 0
    first."""
    img = torch.clamp(img01.to(torch.float32), min=0)
    return gmic_quantize_u8(rl_deblur(img, float(sigma), int(iterations), psf=psf))


def rl_deblur_to_uint8(img01: np.ndarray, sigma: float = 1.0,
                       iterations: int = 10, dt: float = 1.0,
                       device=None) -> np.ndarray:
    """Host [0, 1] HWC image -> uint8 HWC: RL deblur, then the gmic
    quantize. Runs on ``device`` (CUDA unless the CPU is asked for)."""
    from ..utils.device import resolve_device

    x = torch.from_numpy(np.ascontiguousarray(img01, np.float32))
    u = rl_deblur(x.to(resolve_device(device)), sigma, iterations, dt)
    return gmic_quantize_u8(u).cpu().numpy()
