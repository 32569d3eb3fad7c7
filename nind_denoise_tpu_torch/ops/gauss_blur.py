"""Separable Gaussian blur (kernel K3, ``csrc/gauss_blur.cu``).

Counterpart of ``nind_denoise_tpu/ops/pallas_blur.py`` ``gauss_blur_pallas``:
fp32 (H, W, C) blurred with the canonical truncated Gaussian of
``ops/rl_deblur.gaussian_taps_np`` (radius ceil(3 sigma), at most 64), a
vertical pass then a horizontal pass, each edge-replicating its own input.

``gauss_blur`` launches the CUDA kernel for a CUDA tensor and runs
``gauss_blur_reference``, the plain PyTorch version, for a CPU tensor.
``launches`` counts kernel launches. No path of the port calls it yet; it
is the public entry point, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, rl_fused
from .rl_deblur import gaussian_taps_np

MAX_RADIUS = 64  # the kernel's largest shared-memory tile
launches = 0

_SIG = {"gauss_blur_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}


def _taps(sigma: float) -> np.ndarray:
    taps = gaussian_taps_np(sigma)
    r = (len(taps) - 1) // 2
    if r > MAX_RADIUS:
        raise ValueError(f"gauss_blur: kernel radius {r} (sigma={sigma}) exceeds "
                         f"the largest supported radius {MAX_RADIUS}")
    return taps


def gauss_blur_reference(img_hwc: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: the same two passes in the same tap order."""
    taps = _taps(sigma).tolist()
    chw = img_hwc.to(torch.float32).permute(2, 0, 1)
    return rl_fused.blur(chw, taps).permute(1, 2, 0).contiguous()


def gauss_blur(img_hwc: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """(H, W, C) fp32 -> the same shape, blurred; see the module doc."""
    taps = _taps(sigma)
    if img_hwc.device.type == "cpu":
        return gauss_blur_reference(img_hwc, sigma)
    if img_hwc.device.type != "cuda":
        raise ValueError(f"gauss_blur: unsupported device {img_hwc.device}")
    if (img_hwc.dim() != 3 or img_hwc.dtype != torch.float32
            or not img_hwc.is_contiguous()):
        raise ValueError(f"gauss_blur: need contiguous fp32 (H, W, C), got "
                         f"{img_hwc.dtype} {tuple(img_hwc.shape)}")
    h, w, c = img_hwc.shape
    out = torch.empty_like(img_hwc)
    tt = torch.from_numpy(taps).to(img_hwc.device)
    lib = _build.library("gauss_blur", _SIG)
    err = lib.gauss_blur_launch(img_hwc.data_ptr(), out.data_ptr(), tt.data_ptr(),
                                h, w, c, (len(taps) - 1) // 2,
                                torch.cuda.current_stream(img_hwc.device).cuda_stream)
    global launches
    launches += 1
    _build.check(err, "gauss_blur")
    return out
