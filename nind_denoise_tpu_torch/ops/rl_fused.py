"""One fused Richardson-Lucy iteration (kernel K1, ``csrc/rl_iter.cu``).

Counterpart of the per-iteration kernel of
``nind_denoise_tpu/ops/pallas_blur.py`` ``rl_deblur_pallas_fused``:
``u <- u * G*(d / max(G*u, 1e-8))`` on planar fp32 (P, H, W), G the
separable truncated Gaussian of ``taps`` (H pass, then W pass), each blur
edge-replicating its own input.

``rl_iter`` launches the CUDA kernel for CUDA tensors and runs
``rl_iter_reference``, the plain PyTorch version, for CPU tensors.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

EPS = 1e-8
# the kernel's shared-memory tile takes taps up to 2*32+1, the limit of the
# JAX package's fused kernel (pallas_blur._fused_band_h)
MAX_RADIUS = 32
launches = 0

_SIG = {"rl_iter_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}


def _blur_axis(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """1-D blur along ``dim`` with edge replicate, as tap-unrolled shifted
    multiply-adds summed in tap order (ops/rl_deblur.py:_blur_axis)."""
    r = (len(taps) - 1) // 2
    n = x.shape[dim]
    idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
    xp = x.index_select(dim, idx)
    acc = None
    for t, k in enumerate(taps):
        term = k * xp.narrow(dim, t, n)
        acc = term if acc is None else acc + term
    return acc


def blur(x: torch.Tensor, taps) -> torch.Tensor:
    """Separable edge-replicate blur of (..., H, W): H pass, then W."""
    return _blur_axis(_blur_axis(x, taps, -2), taps, -1)


def rl_iter_reference(u: torch.Tensor, d: torch.Tensor, taps) -> torch.Tensor:
    """One RL iteration, plain PyTorch. ``taps``: sequence of floats."""
    taps = [float(t) for t in taps]
    return u * blur(d / torch.clamp(blur(u, taps), min=EPS), taps)


def rl_iter(u: torch.Tensor, d: torch.Tensor, taps: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One RL iteration on (P, H, W) fp32. ``taps``: 1-D fp32 tensor on
    u's device. ``out`` (CUDA only): buffer for the result, distinct from
    u and d; allocated when None."""
    if u.device.type == "cpu":
        return rl_iter_reference(u, d, taps.tolist())
    if u.device.type != "cuda":
        raise ValueError(f"rl_iter: unsupported device {u.device}")
    if u.dim() != 3 or u.shape != d.shape:
        raise ValueError(f"rl_iter: need matching (P, H, W), got "
                         f"{tuple(u.shape)} and {tuple(d.shape)}")
    for name, t in (("u", u), ("d", d), ("taps", taps)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != u.device:
            raise ValueError(f"rl_iter: {name} must be contiguous fp32 on {u.device}")
    r = (taps.numel() - 1) // 2
    if taps.dim() != 1 or taps.numel() != 2 * r + 1 or not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"rl_iter: the kernel takes 3..{2 * MAX_RADIUS + 1} "
                         f"taps (odd), got {taps.numel()}")
    if out is None:
        out = torch.empty_like(u)
    elif (out.shape != u.shape or out.dtype != torch.float32
          or not out.is_contiguous() or out.device != u.device):
        raise ValueError("rl_iter: out must match u")
    if out.data_ptr() in (u.data_ptr(), d.data_ptr()):
        raise ValueError("rl_iter: out must not alias u or d")
    p, h, w = u.shape
    lib = _build.library("rl_iter", _SIG)
    with _build.on_device(u):
        err = lib.rl_iter_launch(u.data_ptr(), d.data_ptr(), out.data_ptr(),
                                 taps.data_ptr(), p, h, w, r,
                                 torch.cuda.current_stream(u.device).cuda_stream)
    global launches
    with _build.COUNT_LOCK:
        launches += 1
    _build.check(err, "rl_iter")
    return out
