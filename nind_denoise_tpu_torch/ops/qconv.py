"""int8 convolution for the quantized UtNet forward (kernel P1, ``csrc/qconv.cu``).

Counterpart of ``nind_denoise_tpu/ops/qconv.py``: symmetric int8 weights
with per-output-channel scales (``quant_kernel``), activations quantized
per sample (``quant_act``) or with a calibrated scalar scale
(``quant_act_static``), the synthetic and image-drawn calibration batches
(``calib_tiles``, ``calib_from_image``, numpy), and the int8 x int8 ->
int32 convolution with its dequant epilogue ``float(acc) * (s_x * s_w)
(+ b)`` (``qconv``, ``qconv_raw``; NHWC input, HWIO weights, padding
'VALID', 'FULL' or explicit pairs, ``lhs_dilation``).

The rounding is JAX's: ``round(x / s)`` is an IEEE fp32 divide and then
round half to even, clipped to +-127, with the 1e-12 floor on the scale.

``conv_int8`` is the kernel's wrapper, on OHWI weights (the kernel's
layout; ``QuantUtNet`` keeps its weights so): it launches P1 for CUDA
tensors and runs ``conv_int8_reference``, the plain PyTorch version, for
CPU tensors. The plain int32 sum is a float64 convolution of the int8
values, exact because the largest sum of the forward (1024 channels x 16
taps x 127 x 127 = 2.6e8) is far below 2^53. ``launches`` counts P1
launches. ``sw`` may hold two scale vectors (2, Cout), chosen by the
output column's parity: the level-4 composed conv of the forward, whose
taps split by that parity (``models/utnet_int8``). Its epilogue options
(the decoder's fp32 addend and bias map, a one-weight PReLU, the static
quantize to int8) replace the torch passes the forward ran after it, in
their order and rounding, so the plain version computes them with those
very ops. On the card, a Cin that is no multiple of 16 is padded with
zero channels (exact), since TMA moves whole 16-byte rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .conv import prelu as _prelu

EPS = 1e-12
launches = 0

_SIG = {"qconv_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16
        + [ctypes.c_void_p] * 5}
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}

Padding = Union[str, Sequence[Tuple[int, int]]]


# -- quantization --------------------------------------------------------------

def _round_clip(x32: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)


def quant_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., cout) kernel -> (int8 kernel, (cout,) fp32 scales
    max|w[..., o]| / 127)."""
    w = w.to(torch.float32)
    axes = tuple(range(w.dim() - 1))
    s = torch.clamp(torch.amax(torch.abs(w), dim=axes), min=EPS) / 127.0
    return _round_clip(w, s), s


def quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, C) -> (int8, (N, 1, 1, 1) fp32 per-sample scales)."""
    x32 = x.to(torch.float32)
    m = torch.amax(torch.abs(x32), dim=(1, 2, 3), keepdim=True)
    s = torch.clamp(m, min=EPS) / 127.0
    return _round_clip(x32, s), s


def quant_act_static(x: torch.Tensor, s: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize with a calibrated scalar scale ``s``; values beyond the
    calibrated range saturate at +-127."""
    return _round_clip(x.to(torch.float32), s), s


def calib_tiles(size: int = 136, seed: int = 0) -> np.ndarray:
    """The deterministic synthetic calibration batch (8, size, size, 3) of
    the JAX package: flat fields at 0, 0.5 and 1, H and V gradients, a
    1-px checkerboard, uniform noise, and noise plus a gradient."""
    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, size, dtype=np.float32)
    hgrad = np.broadcast_to(g[None, :, None], (size, size, 3))
    vgrad = np.broadcast_to(g[:, None, None], (size, size, 3))
    ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    checker = np.broadcast_to((((ii + jj) % 2).astype(np.float32))[..., None],
                              (size, size, 3))
    noise = rng.random((size, size, 3), dtype=np.float32)
    return np.stack([
        np.zeros((size, size, 3), np.float32),
        np.full((size, size, 3), 0.5, np.float32),
        np.ones((size, size, 3), np.float32),
        hgrad, vgrad, checker, noise,
        np.clip(0.75 * vgrad + 0.25 * rng.random(
            (size, size, 3), dtype=np.float32), 0.0, 1.0),
    ])


def calib_from_image(img01, size: int = 136, scale: float = 1.0) -> np.ndarray:
    """Calibration batch from the image being denoised: the four corner
    crops, the centre crop and the crop centred on the brightest pixel
    (found exactly, in row strips of bounded memory). ``img01``: (H, W, 3)
    in [0, 1], or storage pixels with ``scale`` to divide the crops by.
    Reflect-padded up to ``size``. Returns (6, size, size, 3) fp32."""
    img01 = np.asarray(img01)
    h, w = img01.shape[:2]
    if h < size or w < size:
        img01 = np.pad(img01, ((0, max(0, size - h)), (0, max(0, size - w)),
                               (0, 0)), mode="reflect")
        h, w = img01.shape[:2]
    ys = [0, h - size, 0, h - size, (h - size) // 2]
    xs = [0, 0, w - size, w - size, (w - size) // 2]
    strip = max(1, 2_000_000 // max(w, 1))
    best, iy, ix = -np.inf, 0, 0
    for y0 in range(0, h, strip):
        lum = img01[y0:y0 + strip].sum(axis=2, dtype=np.float32)
        j = int(np.argmax(lum))
        v = float(lum.flat[j])
        if v > best:
            best = v
            iy, ix = y0 + j // lum.shape[1], j % lum.shape[1]
    ys.append(int(np.clip(iy - size // 2, 0, h - size)))
    xs.append(int(np.clip(ix - size // 2, 0, w - size)))
    crops = [img01[y:y + size, x:x + size].astype(np.float32) / scale
             for y, x in zip(ys, xs)]
    return np.stack(crops)


# -- the int8 convolution ------------------------------------------------------

def pads_of(padding: Padding, kh: int, kw: int) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of 'VALID', 'FULL' or explicit pairs."""
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding == "FULL":
        return kh - 1, kh - 1, kw - 1, kw - 1
    (pt, pb), (pl, pr) = padding
    return int(pt), int(pb), int(pl), int(pr)


def out_hw(h: int, w: int, kh: int, kw: int, pads, dil: int) -> Tuple[int, int]:
    pt, pb, pl, pr = pads
    return ((h - 1) * dil + 1 + pt + pb - kh + 1,
            (w - 1) * dil + 1 + pl + pr - kw + 1)


def macs(n, ho, wo, cin, cout, k, dil, pad) -> int:
    """MACs of one conv without the lhs dilation's zeros: with dilation 2
    each output pixel reads the ceil or floor of k/2 taps along each axis."""
    if dil == 1:
        return n * ho * wo * cout * cin * k * k
    total = 0
    for py in (0, 1):
        for px in (0, 1):
            ny, nx = (ho - py + 1) // 2, (wo - px + 1) // 2
            ty = len([a for a in range(k) if (py + a - pad) % 2 == 0])
            tx = len([b for b in range(k) if (px + b - pad) % 2 == 0])
            total += ny * nx * ty * tx
    return n * total * cout * cin


def conv_i32_reference(xq: torch.Tensor, wk: torch.Tensor, pads, dil: int
                       ) -> torch.Tensor:
    """Exact int32 conv of int8 NHWC ``xq`` with int8 OHWI ``wk``, as a
    float64 conv (sums far below 2^53)."""
    n, h, w, c = xq.shape
    x = xq.permute(0, 3, 1, 2).to(torch.float64)
    if dil != 1:
        xd = x.new_zeros((n, c, (h - 1) * dil + 1, (w - 1) * dil + 1))
        xd[:, :, ::dil, ::dil] = x
        x = xd
    pt, pb, pl, pr = pads
    x = F.pad(x, (pl, pr, pt, pb))
    y = F.conv2d(x, wk.permute(0, 3, 1, 2).to(torch.float64))
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def _scale_grid(sx: torch.Tensor, sw: torch.Tensor, n: int, wo: int) -> torch.Tensor:
    """sx * sw broadcast to (N, 1, Wo or 1, Cout), in fp32."""
    sxv = sx.to(torch.float32).reshape(-1, 1, 1, 1)
    if sw.dim() == 2:  # (2, cout): the output column's parity picks the row
        swv = sw[torch.arange(wo, device=sw.device) % 2][None, None]
    else:
        swv = sw.reshape(1, 1, 1, -1)
    return sxv * swv.to(torch.float32)


def dequant_reference(acc: torch.Tensor, sx, sw, bias=None,
                      out_dtype=torch.float32, addend=None, bias_map=None,
                      prelu=None, out_scale=None) -> torch.Tensor:
    """P1's epilogue, plain, in the order of the torch ops it replaces:
    ``float(acc) * (sx * sw)``; then in fp32 ``addend +``, ``+ bias_map``,
    ``+ bias``; the cast to ``out_dtype``; PReLU with the one weight
    ``prelu`` in that dtype (``ops/conv.prelu``); and with ``out_scale``
    the static quantize to int8 (``quant_act_static``)."""
    y = acc.to(torch.float32) * _scale_grid(sx, sw, acc.shape[0], acc.shape[2])
    if addend is not None:
        y = addend + y
    if bias_map is not None:
        y = y + bias_map
    if bias is not None:
        y = y + bias.to(torch.float32)
    y = y.to(out_dtype)
    if prelu is not None:
        y = _prelu(y, prelu)
    if out_scale is not None:
        y = quant_act_static(y, out_scale)[0]
    return y


def conv_int8_reference(xq, wk, pads, dil, sx=None, sw=None, bias=None,
                        out_dtype=torch.float32, addend=None, bias_map=None,
                        prelu=None, out_scale=None) -> torch.Tensor:
    """Plain PyTorch version of P1: the exact int32 conv, then for a float
    ``out_dtype`` ``dequant_reference`` with the same options."""
    acc = conv_i32_reference(xq, wk, pads, dil)
    if out_dtype == torch.int32:
        return acc
    return dequant_reference(acc, sx, sw, bias, out_dtype, addend, bias_map, prelu,
                             out_scale)


def _check_f32(name: str, t, shape, dev) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        raise TypeError(f"conv_int8: {name} must be a float32 tensor")
    if t.device != dev:
        raise ValueError(f"conv_int8: {name} on {t.device}, the input on {dev}")
    if tuple(t.shape) not in shape:
        raise ValueError(f"conv_int8: {name} has shape {tuple(t.shape)}, "
                         f"expected one of {sorted(shape)}")
    return t.contiguous()


def conv_int8(xq: torch.Tensor, wk: torch.Tensor, pads, dil: int = 1,
              sx: Optional[torch.Tensor] = None, sw: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.float32,
              addend: Optional[torch.Tensor] = None,
              bias_map: Optional[torch.Tensor] = None,
              prelu: Optional[torch.Tensor] = None,
              out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P1: int8 NHWC ``xq`` (N, H, W, Cin) conv int8 OHWI ``wk`` (Cout,
    KH, KW, Cin), zero padding ``pads`` (top, bottom, left, right) and lhs
    dilation ``dil`` (1 or 2) -> NHWC ``out_dtype``: int32 sums, or fp32 /
    bf16 dequantized with ``sx`` (N or 1 values) and ``sw`` ((Cout,) or
    (2, Cout) by output-column parity), plus ``bias`` (Cout,) if given.

    Epilogue options of a float output, applied as ``dequant_reference``
    orders them: ``addend`` (N, Ho, Wo, Cout) fp32 and ``bias_map``
    (1, Ho, Wo, Cout) fp32, summed in fp32 before ``bias`` (the decoder's
    ``z_a + z_b + bias_map + b``); ``prelu``, the one weight of a PReLU
    applied after the cast; ``out_scale``, one fp32 scale: the result is
    then that value quantized to int8 (``quant_act_static``)."""
    if xq.dim() != 4 or wk.dim() != 4 or xq.shape[3] != wk.shape[3]:
        raise ValueError(f"conv_int8: need (N,H,W,C) and (O,KH,KW,C), got "
                         f"{tuple(xq.shape)} and {tuple(wk.shape)}")
    if xq.dtype != torch.int8 or wk.dtype != torch.int8:
        raise TypeError(f"conv_int8: need int8 operands, got {xq.dtype}, {wk.dtype}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"conv_int8: unsupported out_dtype {out_dtype}")
    if dil not in (1, 2):
        raise ValueError(f"conv_int8: lhs dilation must be 1 or 2, got {dil}")
    n, h, w, cin = xq.shape
    cout, kh, kw, _ = wk.shape
    ho, wo = out_hw(h, w, kh, kw, pads, dil)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"conv_int8: empty output {ho}x{wo}")
    dev = xq.device
    if wk.device != dev:
        raise ValueError("conv_int8: weights and input on different devices")
    if out_dtype != torch.int32:
        if sx is None or sw is None:
            raise ValueError("conv_int8: a float output needs sx and sw")
        if sx.numel() not in (1, n) or sw.shape not in ((cout,), (2, cout)):
            raise ValueError(f"conv_int8: sx {tuple(sx.shape)} / sw "
                             f"{tuple(sw.shape)} do not fit N={n}, Cout={cout}")
    elif any(t is not None for t in (addend, bias_map, prelu, out_scale)):
        raise ValueError("conv_int8: epilogue options need a float out_dtype")
    if addend is not None:
        addend = _check_f32("addend", addend, {(n, ho, wo, cout)}, dev)
    if bias_map is not None:
        bias_map = _check_f32("bias_map", bias_map, {(1, ho, wo, cout), (ho, wo, cout)},
                              dev).reshape(1, ho, wo, cout)
    if prelu is not None:
        prelu = _check_f32("prelu", prelu.detach(), {(1,), ()}, dev)
    if out_scale is not None:
        out_scale = _check_f32("out_scale", out_scale, {(1,), ()}, dev)
    if dev.type == "cpu":
        return conv_int8_reference(xq, wk, pads, dil, sx, sw, bias, out_dtype, addend,
                                   bias_map, prelu, out_scale)
    if dev.type != "cuda":
        raise ValueError(f"conv_int8: unsupported device {dev}")
    if cin % 16:  # TMA rows are whole 16-byte units: zero channels are exact
        cpad = 16 - cin % 16
        xq, wk = F.pad(xq, (0, cpad)), F.pad(wk, (0, cpad))
        cin += cpad
    xq, wk = _aligned(xq), _aligned(wk)
    out = torch.empty((n, ho, wo, cout),
                      dtype=torch.int8 if out_scale is not None else out_dtype, device=dev)
    ptrs = [0] * 7
    keep = []
    if out_dtype != torch.int32:
        for i, t in enumerate((sx, sw, bias)):
            if t is not None:
                t = t.to(dev, torch.float32).contiguous()
                keep.append(t)
                ptrs[i] = t.data_ptr()
        if prelu is not None:  # the weight as the work dtype rounds it
            prelu = prelu.reshape(1).to(out_dtype).to(torch.float32)
            keep.append(prelu)
        for i, t in enumerate((addend, bias_map, prelu, out_scale)):
            if t is not None:
                ptrs[3 + i] = t.data_ptr()
    pt, _, pl, _ = pads
    lib = _build.library("qconv", _SIG)
    with _build.on_device(xq):  # the kernel counts the current device's SMs
        err = lib.qconv_launch(xq.data_ptr(), wk.data_ptr(), out.data_ptr(), *ptrs[:3],
                               n, h, w, cin, ho, wo, cout, kh, kw, pt, pl, dil,
                               int(sx is not None and sx.numel() == n and n > 1),
                               int(sw is not None and sw.dim() == 2),
                               _OUT_KIND[out_dtype], 1, *ptrs[3:],
                               torch.cuda.current_stream(dev).cuda_stream)
    global launches
    with _build.COUNT_LOCK:
        launches += 1
    _build.check(err, "qconv")
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary (TMA's rule for a global base)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# -- the JAX package's entry points (HWIO weights) --------------------------------

def qconv_raw(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, padding: Padding,
              lhs_dilation: Optional[Tuple[int, int]] = None,
              sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize NHWC ``x`` (dynamically, or with the static scale ``sx``;
    an int8 ``x`` is taken as already quantized with scale ``sx``), int8
    conv against HWIO ``wq`` with scales ``sw``, dequantize: fp32, no
    bias."""
    kh, kw = wq.shape[0], wq.shape[1]
    if x.dtype == torch.int8:
        if sx is None:
            raise ValueError("qconv_raw: an int8 input needs its scale")
        xq = x
    else:
        xq, sx = quant_act(x) if sx is None else quant_act_static(x, sx)
    dil = 1 if lhs_dilation is None else int(lhs_dilation[0])
    if lhs_dilation is not None and tuple(lhs_dilation) != (dil, dil):
        raise ValueError(f"qconv_raw: lhs_dilation must be equal in H and W, "
                         f"got {lhs_dilation}")
    return conv_int8(xq, wq.permute(3, 0, 1, 2), pads_of(padding, kh, kw), dil,
                     sx=sx, sw=sw, out_dtype=torch.float32)


def qconv(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
          b: Optional[torch.Tensor] = None, padding: Padding = "VALID",
          lhs_dilation: Optional[Tuple[int, int]] = None,
          sx: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """``qconv_raw`` plus the bias in fp32 and the cast to ``out_dtype``
    (default ``x.dtype``; required for an int8 ``x``)."""
    if out_dtype is None:
        if x.dtype == torch.int8:
            raise ValueError("qconv: an int8 input needs an explicit out_dtype")
        out_dtype = x.dtype
    y = qconv_raw(x, wq, sw, padding, lhs_dilation=lhs_dilation, sx=sx)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(out_dtype)
