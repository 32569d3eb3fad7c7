"""Richardson-Lucy deblur and the gmic quantize, on the device.

Counterpart of ``nind_denoise_tpu/ops/rl_deblur.py``: the reference
pipeline's ``gmic -deblur_richardsonlucy <sigma>,<iterations>,1 -/ 256
cut 0,255 round`` with the exact truncated-FIR Gaussian PSF (radius
ceil(3 sigma), normalized float32 taps), edge-replicate boundary, the
multiplicative iteration ``u <- u * G*(d / max(G*u, 1e-8))`` from
``d = max(x, 0)``, and the ``*65535/256, cut, round`` post-op to uint8.

The route is chosen from the PSF radius R = ceil(3 sigma), the PSF and
dt before any launch (``route_for``), as the JAX package picks its fused
kernel or its XLA path:

- ``"fused"`` (gaussian, dt 1, R <= 32, the fused kernel's limit in both
  packages): one ``rl_fused.rl_iter`` launch an iteration (kernel K1);
- ``"separable_k3"`` (gaussian, 32 < R <= 64, or dt != 1 and R <= 64):
  the XLA path's body, blur, ratio, blur, ``pow(max(corr, 1e-8), dt)``
  when dt != 1, product, with each blur one ``gauss_blur.blur_planes``
  launch (kernel K3) over all planes and the rest as torch ops;
- ``"separable_plain"`` (gaussian, R > 64, sigma > 21.33): the same body
  with the tap-unrolled ``rl_fused.blur``, the counterpart of the JAX
  package's lax ``_blur``;
- ``"deriche"`` (``psf='gmic_fast'``, any dt): the same body with each
  blur the Deriche IIR along H, then W (``deriche.deriche_blur``, two
  launches of kernel P2), so four P2 launches an iteration. sigma is
  clamped at 0.1 there, so sigma 0 gives no NaN.

``impl`` takes the JAX package's ``rl_deblur`` choices (the CLI's
``--rl-impl``): ``"auto"`` is the choice above; ``"xla"`` the separable
body (``separable_k3`` or ``separable_plain`` by R, or ``deriche``);
``"pallas"`` the fused kernel K1, which raises ``NotImplementedError``
where K1 cannot run (dt != 1, ``gmic_fast``, R > 32), as the JAX
package's Pallas path raises outside its limits.

On the CPU every route runs the plain versions of its kernels; the
gaussian dt-1 routes all equal ``rl_fused.rl_iter_reference`` iterated,
bit for bit. ``routes`` counts the calls per route.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import deriche, gauss_blur, rl_fused

ROUTES = ("fused", "separable_k3", "separable_plain", "deriche")
IMPLS = ("auto", "xla", "pallas")
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


def route_for(radius: int, psf: str = "gaussian", dt: float = 1.0,
              impl: str = "auto") -> str:
    """The RL route for PSF radius ``radius``, ``psf``, ``dt`` and
    ``impl``; see the module doc. K1 computes dt 1 only, as the Pallas
    kernel does."""
    if impl not in IMPLS:
        raise ValueError(f"rl_deblur: unknown impl {impl!r}")
    fused_ok = psf == "gaussian" and dt == 1.0 and radius <= rl_fused.MAX_RADIUS
    if impl == "pallas":
        if not fused_ok:
            raise NotImplementedError(
                f"the fused RL kernel takes psf='gaussian', dt=1 and R <= "
                f"{rl_fused.MAX_RADIUS} only (got psf={psf!r}, dt={dt}, R={radius})")
        return "fused"
    if psf == "gmic_fast":
        return "deriche"
    if fused_ok and impl == "auto":
        return "fused"
    if radius <= gauss_blur.MAX_RADIUS:
        return "separable_k3"
    return "separable_plain"


def rl_deblur(img: torch.Tensor, sigma: float = 1.0, iterations: int = 10,
              dt: float = 1.0, psf: str = "gaussian", impl: str = "auto"
              ) -> torch.Tensor:
    """Richardson-Lucy deconvolution of (H, W, C) or (N, H, W, C); returns
    the same shape in float32. Planes are independent, so a batch member
    equals its single-image run bit for bit."""
    if psf not in ("gaussian", "gmic_fast"):
        raise ValueError(f"rl_deblur: unknown psf {psf!r}")
    if img.dim() not in (3, 4):
        raise ValueError(f"rl_deblur: need HWC or NHWC, got {tuple(img.shape)}")
    x = img[None] if img.dim() == 3 else img
    n, h, w, c = x.shape
    d = torch.clamp(x.permute(0, 3, 1, 2).reshape(n * c, h, w)
                    .to(torch.float32), min=0.0).contiguous()
    dt = float(dt)
    route = route_for(psf_radius(sigma), psf, dt, impl)
    routes[route] += 1
    # two u buffers, swapped each iteration; d stays read-only
    bufs = ([torch.empty_like(d), torch.empty_like(d)]
            if d.device.type == "cuda" else [None, None])
    u = d
    if route == "deriche":
        blur = lambda x: deriche.deriche_blur(x, sigma)
    else:
        taps_np = gaussian_taps_np(sigma)
        taps = torch.from_numpy(taps_np).to(d.device)
        taps_list = taps_np.tolist()
        blur = ((lambda x: gauss_blur.blur_planes(x, taps))
                if route == "separable_k3" else (lambda x: rl_fused.blur(x, taps_list)))
    if route == "fused":
        for i in range(int(iterations)):
            u = rl_fused.rl_iter(u, d, taps, out=bufs[i % 2])
    else:
        for i in range(int(iterations)):
            ratio = d / torch.clamp(blur(u), min=rl_fused.EPS)
            corr = blur(ratio)
            if dt != 1.0:
                corr = torch.pow(torch.clamp(corr, min=rl_fused.EPS), dt)
            u = torch.mul(u, corr, out=bufs[i % 2])
    out = u.reshape(n, c, h, w).permute(0, 2, 3, 1)
    return out[0] if img.dim() == 3 else out


def gmic_quantize_u8(u: torch.Tensor) -> torch.Tensor:
    """gmic's ``*65535/256, cut 0-255, round`` -> uint8 (round half to
    even, as jnp.round)."""
    return torch.round(torch.clamp(u * (65535.0 / 256.0), 0, 255)).to(torch.uint8)


def rl_to_u8_device(img01: torch.Tensor, sigma: float = 1.0,
                    iterations: int = 10, psf: str = "gaussian",
                    impl: str = "auto") -> torch.Tensor:
    """RL deblur + gmic quantize on the tensor's device: [0, 1] HWC or
    NHWC in, uint8 of the same shape out. The input is clipped at 0
    first."""
    img = torch.clamp(img01.to(torch.float32), min=0)
    return gmic_quantize_u8(rl_deblur(img, float(sigma), int(iterations), psf=psf,
                                      impl=impl))


def rl_deblur_to_uint8(img01: np.ndarray, sigma: float = 1.0,
                       iterations: int = 10, dt: float = 1.0,
                       device=None, psf: str = "gaussian",
                       impl: str = "auto") -> np.ndarray:
    """Host [0, 1] HWC image -> uint8 HWC: RL deblur, then the gmic
    quantize. Runs on ``device`` (CUDA unless the CPU is asked for)."""
    from ..utils.device import resolve_device

    x = torch.from_numpy(np.ascontiguousarray(img01, np.float32))
    u = rl_deblur(x.to(resolve_device(device)), sigma, iterations, dt, psf=psf,
                  impl=impl)
    return gmic_quantize_u8(u).cpu().numpy()
