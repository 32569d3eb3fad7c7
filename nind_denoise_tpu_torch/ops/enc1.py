"""Fused UtNet encoder level 1 (kernel K2, ``csrc/enc1.cu``).

Counterpart of ``nind_denoise_tpu/ops/pallas_enc1.py`` ``enc1_pallas``:
  t0    = PReLU(conv3x3_valid(x_pad, w0) + b0), rounded to the I/O dtype
  l1    = PReLU(conv3x3_valid(t0, w1) + b1)     (fp32 sums and PReLU)
  l2_in = maxpool2x(l1)
on NCHW: x_pad (B, 3, H+4, W+4) -> (l1 (B, F, H, W), l2_in (B, F, H/2, W/2)).

``enc1`` launches the CUDA kernel for a CUDA tensor (bf16 or fp32 I/O,
F = 64) and runs ``enc1_reference``, the plain PyTorch version, for a CPU
tensor. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .conv import prelu

FUNIT = 64  # the kernel's compiled channel count
launches = 0

_SIG = {"enc1_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}


def enc1_reference(x_pad, w0, b0, a0, w1, b1, a1):
    """Plain PyTorch version, with the kernel's rounding: fp32 sums, bias
    and PReLU in fp32, t0 and l1 rounded to the input dtype."""
    dt = x_pad.dtype

    def layer(t, w, b, a):
        return prelu(F.conv2d(t.float(), w.float(), b.float()), a.float()).to(dt)

    l1 = layer(layer(x_pad, w0, b0, a0), w1, b1, a1)
    return l1, F.max_pool2d(l1, 2)


def supported(x: torch.Tensor, funit: int) -> bool:
    """Whether ``enc1`` takes this input and width (H and W even; the CUDA
    kernel also needs funit 64 and bf16/fp32)."""
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        return False
    return x.device.type == "cpu" or (
        funit == FUNIT and x.dtype in (torch.bfloat16, torch.float32))


def enc1(x_pad, w0, b0, a0, w1, b1, a1):
    """(l1, l2_in) from the reflect-padded input; see the module doc."""
    if x_pad.device.type == "cpu":
        return enc1_reference(x_pad, w0, b0, a0, w1, b1, a1)
    if x_pad.device.type != "cuda":
        raise ValueError(f"enc1: unsupported device {x_pad.device}")
    bsz, cin, hp, wp = x_pad.shape
    h, w = hp - 4, wp - 4
    if cin != 3 or h < 2 or w < 2 or h % 2 or w % 2:
        raise ValueError(f"enc1: need (B, 3, H+4, W+4) with H, W even, got "
                         f"{tuple(x_pad.shape)}")
    if x_pad.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"enc1: unsupported dtype {x_pad.dtype}")
    if tuple(w0.shape) != (FUNIT, 3, 3, 3) or tuple(w1.shape) != (FUNIT, FUNIT, 3, 3):
        raise ValueError(f"enc1: the kernel needs funit {FUNIT}, got weights "
                         f"{tuple(w0.shape)}, {tuple(w1.shape)}")
    if not x_pad.is_contiguous():
        raise ValueError("enc1: x_pad must be contiguous")
    dev = x_pad.device
    for t in (w0, b0, a0, w1, b1, a1):
        if t.device != dev:
            raise ValueError("enc1: weights and input on different devices")
    w0f = w0.float().contiguous()
    w1r = w1.float().permute(1, 2, 3, 0).contiguous()  # (ci, ky, kx, co)
    ba = torch.cat([b0.float().reshape(-1), b1.float().reshape(-1),
                    a0.float().reshape(1), a1.float().reshape(1)])
    l1 = torch.empty((bsz, FUNIT, h, w), dtype=x_pad.dtype, device=dev)
    l2 = torch.empty((bsz, FUNIT, h // 2, w // 2), dtype=x_pad.dtype, device=dev)
    lib = _build.library("enc1", _SIG)
    err = lib.enc1_launch(x_pad.data_ptr(), w0f.data_ptr(), w1r.data_ptr(),
                          ba.data_ptr(), l1.data_ptr(), l2.data_ptr(),
                          bsz, h, w, int(x_pad.dtype == torch.bfloat16),
                          torch.cuda.current_stream(dev).cuda_stream)
    global launches
    launches += 1
    _build.check(err, "enc1")
    return l1, l2
