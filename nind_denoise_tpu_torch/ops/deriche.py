"""Deriche order-0 recursive Gaussian (kernel P2, ``csrc/deriche.cu``).

Counterpart of ``nind_denoise_tpu/ops/rl_deblur.py`` ``_deriche_coeffs``,
``_deriche_axis`` and ``_deriche_blur``: the IIR approximation of a
Gaussian that G'MIC's fast blur runs (CImg ``deriche()``), and that RL
uses for ``psf='gmic_fast'``. Along one axis of planar fp32 (P, H, W), a
causal and an anticausal second-order recurrence with neumann starts,
summed; ``deriche_blur`` runs along H, then along W.

``deriche_axis`` launches the CUDA kernel for a CUDA tensor and runs
``deriche_axis_reference``, the plain PyTorch version (a loop over the
axis), for a CPU tensor. ``launches`` counts kernel launches. The
coefficients are host math in double, rounded to fp32 once: the JAX
package multiplies its fp32 arrays by the same Python floats.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

from . import _build

KEYS = ("a0", "a1", "a2", "a3", "b1", "b2", "coefp", "coefn")
launches = 0

_SIG = {"deriche_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
        + [ctypes.c_float] * 8 + [ctypes.c_void_p]}


def coeffs(sigma: float) -> Dict[str, float]:
    """CImg's Deriche order-0 coefficients for ``sigma`` (clamped at 0.1),
    each rounded to fp32 (the values are Python floats that are exactly
    fp32)."""
    nsigma = max(float(sigma), 0.1)
    alpha = 1.695 / nsigma
    ema = math.exp(-alpha)
    ema2 = math.exp(-2.0 * alpha)
    b1, b2 = -2.0 * ema, ema2
    k = (1.0 - ema) ** 2 / (1.0 + 2.0 * alpha * ema - ema2)
    a0, a1 = k, k * (alpha - 1.0) * ema
    a2, a3 = k * (alpha + 1.0) * ema, -k * ema2
    coefp = (a0 + a1) / (1.0 + b1 + b2)
    coefn = (a2 + a3) / (1.0 + b1 + b2)
    vals = dict(a0=a0, a1=a1, a2=a2, a3=a3, b1=b1, b2=b2, coefp=coefp, coefn=coefn)
    return {k: float(np.float32(v)) for k, v in vals.items()}


def deriche_axis_reference(x: torch.Tensor, sigma: float, axis: int) -> torch.Tensor:
    """Plain PyTorch version: the two recurrences as loops over ``axis``,
    each step ``a*x + a'*x' - b1*y' - b2*y''`` in that order."""
    c = coeffs(sigma)
    a0, a1, a2, a3, b1, b2, cp, cn = (c[k] for k in KEYS)
    xm = x.movedim(axis, 0)
    n = xm.shape[0]
    x0 = xm[0]
    xp, yp, yb = x0, cp * x0, cp * x0
    causal = []
    for i in range(n):
        xc = xm[i]
        yc = a0 * xc + a1 * xp - b1 * yp - b2 * yb
        causal.append(yc)
        xp, yb, yp = xc, yp, yc
    xl = xm[n - 1]
    xn, xa, yn, ya = xl, xl, cn * xl, cn * xl
    anti = [None] * n
    for i in range(n - 1, -1, -1):
        xc = xm[i]
        yc = a2 * xn + a3 * xa - b1 * yn - b2 * ya
        anti[i] = yc
        xa, xn, ya, yn = xn, xc, yn, yc
    return (torch.stack(causal) + torch.stack(anti)).movedim(0, axis)


def deriche_axis(x: torch.Tensor, sigma: float, axis: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Deriche blur of (P, H, W) fp32 along ``axis`` (1: H, 2: W).
    ``out`` (CUDA only): buffer for the result, distinct from x."""
    if axis not in (1, 2):
        raise ValueError(f"deriche_axis: axis must be 1 (H) or 2 (W), got {axis}")
    if x.device.type == "cpu":
        return deriche_axis_reference(x, sigma, axis)
    if x.device.type != "cuda":
        raise ValueError(f"deriche_axis: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"deriche_axis: need contiguous fp32 (P, H, W), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != torch.float32
          or not out.is_contiguous() or out.device != x.device):
        raise ValueError("deriche_axis: out must match x")
    if out.data_ptr() == x.data_ptr():
        raise ValueError("deriche_axis: out must not alias x")
    p, h, w = x.shape
    c = coeffs(sigma)
    lib = _build.library("deriche", _SIG)
    err = lib.deriche_launch(x.data_ptr(), out.data_ptr(), p, h, w, axis,
                             *(c[k] for k in KEYS),
                             torch.cuda.current_stream(x.device).cuda_stream)
    global launches
    launches += 1
    _build.check(err, "deriche")
    return out


def deriche_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """G'MIC's fast-approximation blur of (P, H, W): along H, then W."""
    return deriche_axis(deriche_axis(x, sigma, 1), sigma, 2)
