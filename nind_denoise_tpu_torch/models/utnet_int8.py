"""The int8 UtNet forward, as a PyTorch ``nn.Module`` built from a float UtNet.

Counterpart of ``nind_denoise_tpu/models/utnet.py`` ``precompute_int8``,
``calibrate_int8`` and ``apply_int8`` (the engine modes ``int8`` and
``int8_static``): every interior conv runs int8 x int8 -> int32 through
kernel P1 (``ops/qconv.conv_int8``) with per-output-channel weight scales
and activations quantized per sample (dynamic) or with calibrated scalar
scales (static). The graph keeps the JAX forward's quantize points:

- level 1: dynamic mode runs it in the work dtype through K2
  (``ops/enc1``, as ``UtNet.encode1``); static mode runs c0 in the work
  dtype, then PReLU, a static quantize and c1 in int8 through P1;
- before each 2x2 max-pool the static mode quantizes first and pools int8
  (a monotone map commutes with max exactly);
- encoder levels 2-4 and the bottom: two int8 convs each;
- decoder levels 1-3: the composed up-conv (``ops/compose``, a 4x4 conv
  with lhs dilation 2) and the skip conv (3x3 FULL), both int8 and summed
  in fp32 with the up-conv's bias map and the conv bias, then the cast,
  the activation and the int8 ``c1`` (3x3 FULL); the skip conv's P1
  epilogue does that sum, the cast and the PReLU;
- level 4 the same, the composed conv carrying two weight-scale vectors
  chosen by the output column's parity, then the final 1x1 in the work
  dtype and the crop.

The JAX forward runs level 1 and level 4 width-folded (a TPU layout).
Folding is exact in float, and for the 3x3 kernels every folded output
phase sees all nine taps, so their scales are the unfolded ones. The
folded level-4 composed kernel is quantized per (output channel, output
column parity): phase v sees only composed taps of one parity. So the
unfolded composed conv here quantizes each tap column with the scale of
its parity class, and P1's epilogue picks the scale row by the output
column's parity. Odd H or W runs the exact float forward, decided from
the shape.

P1's epilogue (``ops/qconv.conv_int8``) also applies each conv's bias and
a one-weight PReLU and, in static mode, quantizes the output where one
quantize site reads it (each double conv's c0, the bottom's c1, the
decoder sum, each ``dec{l}_c1q`` but level 4's), rounding as the torch
ops it replaces. The encoder's c1 outputs feed a pool and a skip with two
scales and stay in the work dtype; the dynamic mode's quantize needs each
sample's amax first and stays a torch pass. Other activations keep their
torch pass.

``calibrate(calib)`` runs one observing forward (dynamic quantization,
fp32, no TF32) and sets the static scales ``max|input| * headroom / 127``
of the 21 sites, named as in the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import compose
from ..ops import enc1 as enc1_op
from ..ops import qconv as Q
from ..ops.conv import apply_activation, reflect_pad
from .utnet import UtNet

FULL3 = (2, 2, 2, 2)
VALID = (0, 0, 0, 0)
UP_PADS = (3, 3, 3, 3)  # the composed 4x4 conv, lhs dilation 2


def conv_shapes(cs: int = 504, f: int = 64):
    """Every int8 conv of the funit-``f`` forward on cs x cs tiles, in the
    forward's order: (site, input edge, cin, cout, k, pads, lhs dilation).
    The first, enc1's c1, runs in int8_static only."""
    V, FU, UP = VALID, FULL3, UP_PADS
    shapes = [("enc1_c1fq", cs + 2, f, f, 3, V, 1)]
    skips = [(cs, f)]  # l1
    h, c = cs // 2, f
    for name in ("convs2", "convs3", "convs4"):
        shapes += [(f"{name}_c0q", h, c, 2 * c, 3, V, 1),
                   (f"{name}_c1q", h - 2, 2 * c, 2 * c, 3, V, 1)]
        c *= 2
        skips.append((h - 4, c))
        h = (h - 4) // 2
    shapes += [("bottom_c0q", h, c, 2 * c, 3, V, 1),
               ("bottom_c1q", h - 2, 2 * c, 2 * c, 3, FU, 1)]
    c *= 2
    for lvl, (hs, cskip) in enumerate(reversed(skips)):
        names = ("K3fq", "w3b4q", "dec4_c1q") if lvl == 3 else \
            (f"K{lvl}q", f"skip{lvl}q", f"dec{lvl}_c1q")
        co = c // 2
        shapes += [(names[0], h, c, co, 4, UP, 2), (names[1], hs, cskip, co, 3, FU, 1),
                   (names[2], hs + 2, co, co, 3, FU, 1)]
        h, c = hs + 4, co
    return shapes


def site_epilogue(site: str):
    """The epilogue the PReLU forward gives P1 at ``site``: ``"raw"`` (the
    composed up-conv's fp32 sum), ``"sum"`` (the skip conv: the decoder's
    fp32 sum, bias, PReLU) or ``"act"`` (bias, PReLU); and whether
    int8_static quantizes its output there for the one site that reads it."""
    if site.startswith("K"):
        return "raw", False
    if site.startswith("skip") or site == "w3b4q":
        return "sum", True
    return "act", site.endswith("_c0q") or site.startswith("bottom") or \
        (site.startswith("dec") and site != "dec4_c1q")


def conv_hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.detach().permute(2, 3, 1, 0)


def tconv_hwio(tconv: nn.ConvTranspose2d) -> torch.Tensor:
    """A stride-1 3x3 transposed conv's kernel in plain-conv (flipped)
    HWIO form, the JAX package's parameter layout."""
    return tconv.weight.detach().flip(2, 3).permute(2, 3, 0, 1)


def up_matrix(up: nn.ConvTranspose2d) -> torch.Tensor:
    """The 2x2 stride-2 up-conv as the JAX package's (cin, 4*cout) matrix,
    column (u*2+v)*cout + o."""
    w = up.weight.detach()
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def parity_quant(k: torch.Tensor):
    """Quantize a conv-form 4x4 composed kernel (4, 4, cin, cout) with a
    scale per (output column parity q, cout): output columns of parity q
    read only the tap columns b with (b + 1) % 2 == q. Returns the int8
    kernel and the (2, cout) scales."""
    cols = [[b for b in range(k.shape[1]) if (b + 1) % 2 == q] for q in (0, 1)]
    s = torch.stack([torch.clamp(torch.amax(torch.abs(k[:, c]), dim=(0, 1, 2)),
                                 min=Q.EPS) / 127.0 for c in cols])
    per_tap = torch.stack([s[(b + 1) % 2] for b in range(k.shape[1])])  # (kw, cout)
    return Q._round_clip(k, per_tap[None, :, None, :]), s


@contextlib.contextmanager
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _pool(t: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of NHWC (floors odd sizes), float or int8."""
    n, h, w, c = t.shape
    t = t[:, :h // 2 * 2, :w // 2 * 2]
    return t.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _nhwc_conv(x: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
    """Float conv (VALID, no bias) of NHWC in its dtype -> NHWC contiguous."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw.to(x.dtype))
    return y.permute(0, 2, 3, 1).contiguous()


class QuantUtNet(nn.Module):
    """``QuantUtNet(model, static=False, device=None)``; forward takes NCHW
    in the work dtype (bf16 in the engine, fp32 in the tests) and returns
    NCHW in it. ``static`` needs ``calibrate`` before the first forward."""

    DECODER = (("up1", "tconvs1"), ("up2", "tconvs2"), ("up3", "tconvs3"))

    def __init__(self, model: UtNet, static: bool = False, device=None):
        super().__init__()
        dev = torch.device(device) if device is not None else \
            next(model.parameters()).device
        self.static = bool(static)
        self.activation = model.activation
        self.exact = copy.deepcopy(model).to(dev, torch.float32).eval().requires_grad_(False)
        m = self.exact
        self.sites = []
        self._bmaps: Dict[tuple, torch.Tensor] = {}
        self._exact_by_dtype: Dict[torch.dtype, nn.Module] = {}

        def add(key, w_hwio=None, wq=None, s=None):
            if wq is None:
                wq, s = Q.quant_kernel(w_hwio)
            self.register_buffer(f"{key}_w", wq.permute(3, 0, 1, 2).contiguous())
            self.register_buffer(f"{key}_s", s.contiguous())
            self.sites.append(key)

        with torch.no_grad():
            add("enc1_c1fq", conv_hwio(m.convs1[2]))
            for name in ("convs2", "convs3", "convs4"):
                seq = getattr(m, name)
                add(f"{name}_c0q", conv_hwio(seq[0]))
                add(f"{name}_c1q", conv_hwio(seq[2]))
            add("bottom_c0q", conv_hwio(m.bottom[0]))
            add("bottom_c1q", tconv_hwio(m.bottom[2]))
            taps = []
            for lvl, (up, tc) in enumerate(self.DECODER + (("up4", "tconvs4"),)):
                up_m, tc_m = getattr(m, up), getattr(m, tc)
                cmid = up_m.weight.shape[1]
                w3 = tconv_hwio(tc_m[0])
                k = compose.compose_up3(up_matrix(up_m), w3[:, :, :cmid])
                if lvl < 3:
                    add(f"K{lvl}q", k)
                    add(f"skip{lvl}q", w3[:, :, cmid:])
                    add(f"dec{lvl}_c1q", tconv_hwio(tc_m[2]))
                else:
                    wq, s = parity_quant(k)
                    add("K3fq", wq=wq, s=s)
                    add("w3b4q", w3[:, :, cmid:])
                    add("dec4_c1q", tconv_hwio(tc_m[2]))
                taps.append(compose.bias_taps(up_m.bias.detach(), w3[:, :, :cmid]))
            for lvl, t in enumerate(taps):
                self.register_buffer(f"bias_taps{lvl}", t)
            for key in self.sites:
                self.register_buffer(f"act_{key}", torch.ones((), device=dev))
        self.calibrated = False

    # -- weights and scales -----------------------------------------------------

    def qweight(self, key: str):
        """Site ``key``'s int8 OHWI kernel and its scales ((cout,), or
        (2, cout) by output column parity for ``K3fq``)."""
        return getattr(self, f"{key}_w"), getattr(self, f"{key}_s")

    @property
    def acts(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, f"act_{k}") for k in self.sites}

    def _bias_map(self, lvl: int, h2: int, w2: int) -> torch.Tensor:
        taps = getattr(self, f"bias_taps{lvl}")
        key = (lvl, h2, w2, taps.device)
        if key not in self._bmaps:
            self._bmaps[key] = compose.up_bias_map(h2, w2, taps)
        return self._bmaps[key]

    # -- calibration ------------------------------------------------------------

    def calibrate(self, calib, headroom: float = 1.3) -> Dict[str, torch.Tensor]:
        """Static scales from one observing forward over ``calib``
        ((N, s, s, 3) in [0, 1], numpy or tensor; s even): each site's
        ``(max|input| * headroom + 1e-12) / 127`` in fp32. Sets and returns
        them."""
        dev = self.act_enc1_c1fq.device
        x = (calib if isinstance(calib, torch.Tensor)
             else torch.from_numpy(np.asarray(calib, np.float32))).to(dev, torch.float32)
        h, w = x.shape[1], x.shape[2]
        if h % 2 or w % 2:
            raise ValueError(
                f"calibrate needs an even-sized calibration batch (got {h}x{w}): "
                f"the int8 forward takes the exact forward on odd sizes and cannot "
                f"observe activation scales there")
        rec: Dict[str, torch.Tensor] = {}
        with torch.inference_mode(), _no_tf32():
            self._forward_nhwc(x, rec)
        acts = {k: (v.to(torch.float32) * headroom + 1e-12) / 127.0 for k, v in rec.items()}
        for k, v in acts.items():
            setattr(self, f"act_{k}", v.clone())
        self.calibrated = True
        return acts

    # the resolved forward's per-image hook, as the JAX engine's
    # ``apply_fn.recalibrate`` (TileEngine.recalibrate_int8 calls it)
    recalibrate = calibrate

    # -- forward ----------------------------------------------------------------

    def _exact_forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype not in self._exact_by_dtype:
            self._exact_by_dtype[x.dtype] = self.exact if x.dtype == torch.float32 \
                else copy.deepcopy(self.exact).to(x.dtype)
        return self._exact_by_dtype[x.dtype](x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in the work dtype -> NCHW; odd H or W take the exact
        forward."""
        h, w = x.shape[-2:]
        if h % 2 or w % 2:
            return self._exact_forward(x)
        if self.static and not self.calibrated:
            raise RuntimeError("QuantUtNet(static=True) needs calibrate() first")
        return self._forward_nhwc(x.permute(0, 2, 3, 1), None).permute(0, 3, 1, 2)

    def _forward_nhwc(self, x: torch.Tensor, rec: Optional[dict]) -> torch.Tensor:
        m = self.exact
        work = x.dtype
        f32 = torch.float32
        acts = self.acts if (self.static and rec is None) else None
        act = lambda t, a_mod: apply_activation(t, self.activation,
                                                getattr(a_mod, "weight", None))

        def quant(t, key):
            if rec is not None:
                rec[key] = torch.amax(torch.abs(t.to(f32)))
            if t.dtype == torch.int8:  # quantized before its pool
                return t, acts[key]
            return Q.quant_act(t) if acts is None else Q.quant_act_static(t, acts[key])

        def qc(t, key, pads, bias=None, dil=1, act_mod=None, addend=None, bmap=None,
               next_key=None):
            """int8 conv with bias in the work dtype, then ``act_mod``'s
            activation; bias and addend None: the raw fp32 dequantized sum.
            P1's epilogue takes the decoder's fp32 sum (``addend``,
            ``bmap``), a one-weight PReLU and, in static mode, the quantize
            of the one site ``next_key`` that reads the result (int8 out)."""
            tq, sx = quant(t, key)
            wq, sw = self.qweight(key)
            a = getattr(act_mod, "weight", None)
            fuse = self.activation == "PReLU" and a is not None and a.numel() == 1
            raw = bias is None and addend is None
            y = Q.conv_int8(tq, wq, pads, dil, sx=sx, sw=sw,
                            bias=None if bias is None else bias.detach(),
                            out_dtype=f32 if raw else work, addend=addend, bias_map=bmap,
                            prelu=a if fuse else None,
                            out_scale=acts[next_key] if fuse and acts is not None
                            and next_key is not None else None)
            return y if act_mod is None or fuse else act(y, act_mod)

        def pool_q(t, key):
            return _pool(t) if acts is None else _pool(Q.quant_act_static(t, acts[key])[0])

        def double_q(name, t):
            seq = getattr(m, name)
            t = qc(t, f"{name}_c0q", VALID, seq[0].bias, act_mod=seq[1],
                   next_key=f"{name}_c1q")
            return qc(t, f"{name}_c1q", VALID, seq[2].bias, act_mod=seq[3])

        # level 1
        c0, p0, c1, p1 = m.convs1
        xp = reflect_pad(x.permute(0, 3, 1, 2), 2)
        if acts is None and rec is None and self.activation == "PReLU" \
                and enc1_op.supported(x.permute(0, 3, 1, 2), c0.out_channels):
            l1, l2_in = enc1_op.enc1(xp.contiguous(), *(t.to(work) for t in (
                c0.weight, c0.bias, p0.weight, c1.weight, c1.bias, p1.weight)))
            l1 = l1.permute(0, 2, 3, 1).contiguous()
            l2_in = l2_in.permute(0, 2, 3, 1).contiguous()
        else:
            t = act(_nhwc_conv(xp.permute(0, 2, 3, 1), c0.weight) + c0.bias.to(work), p0)
            if acts is not None:
                l1 = qc(t, "enc1_c1fq", VALID, c1.bias, act_mod=p1)
            else:
                if rec is not None:
                    rec["enc1_c1fq"] = torch.amax(torch.abs(t.to(f32)))
                l1 = act(_nhwc_conv(t, c1.weight) + c1.bias.to(work), p1)
            l2_in = pool_q(l1, "convs2_c0q")

        l2 = double_q("convs2", l2_in)
        l3 = double_q("convs3", pool_q(l2, "convs3_c0q"))
        l4 = double_q("convs4", pool_q(l3, "convs4_c0q"))
        b = m.bottom
        t = qc(pool_q(l4, "bottom_c0q"), "bottom_c0q", VALID, b[0].bias, act_mod=b[1],
               next_key="bottom_c1q")
        t = qc(t, "bottom_c1q", FULL3, b[2].bias, act_mod=b[3], next_key="K0q")

        for lvl, (skip, tc) in enumerate(((l4, m.tconvs1), (l3, m.tconvs2),
                                          (l2, m.tconvs3), (l1, m.tconvs4))):
            kq = "K3fq" if lvl == 3 else f"K{lvl}q"
            sq = "w3b4q" if lvl == 3 else f"skip{lvl}q"
            cq = "dec4_c1q" if lvl == 3 else f"dec{lvl}_c1q"
            nq = ("K1q", "K2q", "K3fq", None)[lvl]
            z_a = qc(t, kq, UP_PADS, dil=2)
            bmap = self._bias_map(lvl, skip.shape[1], skip.shape[2])
            # (z_a + z_b + bmap + b) in fp32, the cast, the activation
            y = qc(skip, sq, FULL3, tc[0].bias.to(f32), act_mod=tc[1], addend=z_a,
                   bmap=bmap, next_key=cq)
            t = qc(y, cq, FULL3, tc[2].bias, act_mod=tc[3], next_key=nq)

        final = m.tconvs4[4]
        y = t @ final.weight.detach().reshape(final.out_channels, -1).t().to(work)
        y = y + final.bias.detach().to(work)
        return y[:, 2:-2, 2:-2, :]
