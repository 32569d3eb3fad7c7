"""Fused UtNet encoder level 1 (kernel K2, ``csrc/enc1.cu``).

Counterpart of ``nind_denoise_tpu/ops/pallas_enc1.py`` ``enc1_pallas``:
  t0    = PReLU(conv3x3_valid(x_pad, w0) + b0), rounded to the I/O dtype
  l1    = PReLU(conv3x3_valid(t0, w1) + b1)     (fp32 sums and PReLU)
  l2_in = maxpool2x(l1)
on NCHW: x_pad (B, 3, H+4, W+4) -> (l1 (B, F, H, W), l2_in (B, F, H/2, W/2)).

``enc1`` launches the CUDA kernel for a CUDA tensor (F = 64) and runs
``enc1_reference``, the plain PyTorch version, for a CPU tensor.
``launches`` counts kernel launches.

- bf16 (the product path): both convolutions on the tensor cores, fp32
  sums: c1 on ``wgmma`` m64n64k16 with w1 read from shared memory, c0 on
  ``mma.sync`` m16n8k16 (steps 1 and 2 of the Hopper design). Weights,
  biases and PReLU slopes must be bf16. The bound at B = 8, 504 x 504 is
  0.1586 ms of operations (150 GFLOP at 989 TFLOP/s). Persistent CTAs, at
  most one per SM, each hold the whole of w1 (``pack_w1``, 73,728 B) and
  walk 16 x 16 output tiles, two at a time; the header of ``csrc/enc1.cu``
  has the shared-memory reckoning. ``tile_grid``, ``cta_count`` and
  ``walk`` give the order the kernel walks the tiles in.
- fp32 (only under ``--compute_dtype float32``): the CUDA-core kernel;
  TF32 would break its 1e-4 x max(1, |l1|) limit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build
from .conv import prelu

FUNIT = 64  # the kernel's compiled channel count
TILE = 16  # output tile edge of the bf16 kernel
GROUPS = 2  # tiles in flight per CTA of the bf16 kernel
launches = 0

_SIG = {
    "enc1_bf16_launch": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "enc1_f32_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def enc1_reference(x_pad, w0, b0, a0, w1, b1, a1):
    """Plain PyTorch version, with the kernel's rounding: fp32 sums, bias
    and PReLU in fp32, t0 and l1 rounded to the input dtype."""
    dt = x_pad.dtype

    def layer(t, w, b, a):
        return prelu(F.conv2d(t.float(), w.float(), b.float()), a.float()).to(dt)

    l1 = layer(layer(x_pad, w0, b0, a0), w1, b1, a1)
    return l1, F.max_pool2d(l1, 2)


@functools.lru_cache(maxsize=None)
def _pack_index(f: int, device: torch.device) -> torch.Tensor:
    """Flat indices into w1 (F, F, 3, 3) in ``pack_w1``'s order."""
    s = math.gcd(8, f // 8)
    idx = torch.arange(f * f * 9).reshape(f, f, 3, 3).permute(2, 3, 0, 1)
    idx = idx.reshape(9, f, f // 8, 8)
    co = torch.arange(f)[:, None]
    chunk = torch.arange(f // 8)[None, :] ^ (co % s)
    return idx[:, co, chunk].reshape(-1).to(device)


def pack_w1(w1: torch.Tensor) -> torch.Tensor:
    """w1 (F, F, 3, 3) as the bf16 kernel's B operand of c1: bf16
    (9, F, F), ``[tap][co][ci]`` with tap = ky*3 + kx, and in each co row
    the 8-channel chunks XOR-swizzled, chunk ``c`` stored at
    ``c ^ (co % s)`` with s = gcd(8, F // 8). At F = 64 that is the
    128-byte swizzle, so that ldmatrix reads eight co rows without bank
    conflicts. A permutation of ``w1.to(bfloat16)``, one gather."""
    f = w1.shape[0]
    if tuple(w1.shape) != (f, f, 3, 3) or f % 8:
        raise ValueError(f"pack_w1: need (F, F, 3, 3) with F % 8 == 0, got "
                         f"{tuple(w1.shape)}")
    flat = w1.to(torch.bfloat16).reshape(-1)
    return flat[_pack_index(f, w1.device)].reshape(9, f, f)


def tile_grid(h: int, w: int):
    """(tiles_y, tiles_x) of TILE x TILE output tiles over an (h, w) image;
    tile (ty, tx) covers rows ty*TILE .. ty*TILE + TILE - 1 (clipped), and
    likewise for columns. TILE is even, so no 2x2 pool window straddles
    two tiles."""
    return -(-h // TILE), -(-w // TILE)


def cta_count(n_tiles: int, n_sms: int) -> int:
    """Persistent CTAs for ``n_tiles`` tiles: one per SM at most."""
    return max(1, min(n_sms, -(-n_tiles // GROUPS)))


def walk(cta: int, group: int, n_ctas: int, bsz: int, h: int, w: int):
    """The tiles that group ``group`` of CTA ``cta`` computes, in the
    kernel's order, as (image, first row, first column): tile t is image
    t // (tiles_y*tiles_x), then row-major within the image."""
    ty, tx = tile_grid(h, w)
    for t in range(cta * GROUPS + group, bsz * ty * tx, n_ctas * GROUPS):
        rem = t % (ty * tx)
        yield t // (ty * tx), (rem // tx) * TILE, (rem % tx) * TILE


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
    l1 = torch.empty((bsz, FUNIT, h, w), dtype=x_pad.dtype, device=dev)
    l2 = torch.empty((bsz, FUNIT, h // 2, w // 2), dtype=x_pad.dtype, device=dev)
    lib = _build.library("enc1", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x_pad.dtype == torch.bfloat16:
        ws = (w0, w1, b0, b1, a0, a1)
        if any(t.dtype != torch.bfloat16 for t in ws):
            raise TypeError(f"enc1: bf16 input needs bf16 weights, got "
                            f"{[t.dtype for t in ws]}")
        if x_pad.data_ptr() % 4:
            raise ValueError("enc1: x_pad must be 4-byte aligned")
        w0p, b0c, b1c, a0c, a1c = (t.contiguous() for t in (w0, b0, b1, a0, a1))
        w1p = pack_w1(w1)
        ty, tx = tile_grid(h, w)
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        err = lib.enc1_bf16_launch(x_pad.data_ptr(), w0p.data_ptr(), w1p.data_ptr(),
                                   b0c.data_ptr(), b1c.data_ptr(), a0c.data_ptr(),
                                   a1c.data_ptr(), l1.data_ptr(), l2.data_ptr(),
                                   bsz, h, w, ty, tx, cta_count(bsz * ty * tx, n_sms),
                                   stream)
    else:
        w0f = w0.float().contiguous()
        w1r = w1.float().permute(1, 2, 3, 0).contiguous()  # (ci, ky, kx, co)
        ba = torch.cat([b0.float().reshape(-1), b1.float().reshape(-1),
                        a0.float().reshape(1), a1.float().reshape(1)])
        err = lib.enc1_f32_launch(x_pad.data_ptr(), w0f.data_ptr(), w1r.data_ptr(),
                                  ba.data_ptr(), l1.data_ptr(), l2.data_ptr(),
                                  bsz, h, w, stream)
    global launches
    launches += 1
    _build.check(err, "enc1")
    return l1, l2
