"""Separable Gaussian blur (kernel K3, ``csrc/gauss_blur.cu``).

Counterpart of ``nind_denoise_tpu/ops/pallas_blur.py`` ``gauss_blur_pallas``:
fp32 (H, W, C) blurred with the canonical truncated Gaussian of
``ops/rl_deblur.gaussian_taps_np`` (radius ceil(3 sigma), at most 64), a
vertical pass then a horizontal pass, each edge-replicating its own input.

``gauss_blur`` launches the CUDA kernel for a CUDA tensor and runs
``gauss_blur_reference``, the plain PyTorch version, for a CPU tensor; it
is the public entry point, as in the JAX package. ``blur_planes`` runs the
same kernel over planar fp32 (P, H, W) with the taps given as a tensor
(``rl_fused.blur`` on the CPU): ``ops/rl_deblur`` calls it on its
``"separable_k3"`` route (32 < R <= 64). ``launches`` counts kernel
launches of both.

The kernel has an instance per radius (a table of launchers in the C
entry), register-blocked passes, one CTA for all channels of a 64 x 32
tile (128 x 32 above R 16), and stays bit-equal to the plain version; its
source note says what bounds it. ``tools/gauss_blur_breakdown.py`` times
it on the card beside variants and an earlier tree's kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import _build, rl_deblur, rl_fused

MAX_RADIUS = 64  # the kernel's largest shared-memory tile
launches = 0

_SIG = {"gauss_blur_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p],
        "gauss_blur_planes_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}


def _taps(sigma: float) -> np.ndarray:
    taps = rl_deblur.gaussian_taps_np(sigma)
    r = (len(taps) - 1) // 2
    if r > MAX_RADIUS:
        raise ValueError(f"gauss_blur: kernel radius {r} (sigma={sigma}) exceeds "
                         f"the largest supported radius {MAX_RADIUS}")
    return taps


@functools.lru_cache(maxsize=64)
def _device_taps(sigma: float, device: torch.device) -> torch.Tensor:
    """The taps on ``device``, copied once per sigma: a copy from pageable
    memory would hold the host at every call."""
    return torch.from_numpy(_taps(sigma)).to(device)


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
    tt = _device_taps(float(sigma), img_hwc.device)
    lib = _build.library("gauss_blur", _SIG)
    err = lib.gauss_blur_launch(img_hwc.data_ptr(), out.data_ptr(), tt.data_ptr(),
                                h, w, c, (len(taps) - 1) // 2,
                                torch.cuda.current_stream(img_hwc.device).cuda_stream)
    global launches
    launches += 1
    _build.check(err, "gauss_blur")
    return out


def blur_planes(x: torch.Tensor, taps: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blur each plane of (P, H, W) fp32 with ``taps`` (1-D fp32, 2R+1
    values, R <= MAX_RADIUS, on x's device): the vertical pass, then the
    horizontal, each edge-replicating its input. ``out`` (CUDA only):
    buffer for the result, distinct from x; allocated when None."""
    r = (taps.numel() - 1) // 2
    if taps.dim() != 1 or taps.numel() != 2 * r + 1 or not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"blur_planes: the kernel takes 3..{2 * MAX_RADIUS + 1} "
                         f"taps (odd), got {taps.numel()}")
    if x.device.type == "cpu":
        return rl_fused.blur(x, taps.tolist())
    if x.device.type != "cuda":
        raise ValueError(f"blur_planes: unsupported device {x.device}")
    for name, t in (("x", x), ("taps", taps)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"blur_planes: {name} must be contiguous fp32 on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"blur_planes: need (P, H, W), got {tuple(x.shape)}")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != torch.float32
          or not out.is_contiguous() or out.device != x.device):
        raise ValueError("blur_planes: out must match x")
    if out.data_ptr() == x.data_ptr():
        raise ValueError("blur_planes: out must not alias x")
    p, h, w = x.shape
    lib = _build.library("gauss_blur", _SIG)
    err = lib.gauss_blur_planes_launch(x.data_ptr(), out.data_ptr(), taps.data_ptr(),
                                       p, h, w, r,
                                       torch.cuda.current_stream(x.device).cuda_stream)
    global launches
    launches += 1
    _build.check(err, "blur_planes")
    return out
