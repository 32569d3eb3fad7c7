"""The two generators as plain functions of a weight dictionary, float32.

A frozen, independent copy of the published architectures, written from
their descriptions and not from the program under test:

- UtNet (github.com/trougnouf/nind-denoise, networks/UtNet.py): reflect
  pad 2, four levels of two VALID 3x3 convs with PReLU and a 2x2 max pool
  between them, a bottom conv and 3x3 transposed conv, four 2x2 stride-2
  transposed-conv ups each concatenated before its skip, two 3x3
  transposed convs a level, a 1x1 conv to RGB, a crop of 2.
- UNet (networks/nnModules.py): double blocks of SAME 3x3 conv,
  BatchNorm and ReLU, a 64-128-256-512-512 encoder with 2x2 max pools,
  2x2 stride-2 transposed-conv ups centre-padded to their skip and
  concatenated after it, a 1x1 conv and a sigmoid.

The weight names are the state-dict names of those modules, so the same
dictionary loads into the program's modules. ``param_shapes`` gives them;
``forward`` runs a network from a dictionary. Every convolution goes
through ``conv`` and ``conv_t``, whose ``round_operands`` hook lets a
lower-precision control round the inputs and weights of each
convolution (``fp8_rounding``). Nothing here imports the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

UNET_CHANNELS = (64, 128, 256, 512, 512)
UNET_UPS = ((1024, 256), (512, 128), (256, 64), (128, 64))
BN_EPS = 1e-5

Shapes = List[Tuple[str, Tuple[int, ...], str]]


def _conv_shapes(prefix: str, cin: int, cout: int, k: int, transposed: bool = False) -> Shapes:
    w = (cin, cout, k, k) if transposed else (cout, cin, k, k)
    return [(f"{prefix}.weight", w, "conv_t" if transposed else "conv"),
            (f"{prefix}.bias", (cout,), "bias")]


def utnet_shapes(funit: int) -> Shapes:
    """(name, shape, kind) of every UtNet parameter, in module order; kind
    is ``conv``, ``conv_t``, ``bias`` or ``prelu``."""
    f = funit
    out: Shapes = []

    def dbl(name, cin, cmid, cout, t=False):
        out.extend(_conv_shapes(f"{name}.0", cin, cmid, 3, t))
        out.append((f"{name}.1.weight", (1,), "prelu"))
        out.extend(_conv_shapes(f"{name}.2", cmid, cout, 3, t))
        out.append((f"{name}.3.weight", (1,), "prelu"))

    dbl("convs1", 3, f, f)
    dbl("convs2", f, 2 * f, 2 * f)
    dbl("convs3", 2 * f, 4 * f, 4 * f)
    dbl("convs4", 4 * f, 8 * f, 8 * f)
    out.extend(_conv_shapes("bottom.0", 8 * f, 16 * f, 3))
    out.append(("bottom.1.weight", (1,), "prelu"))
    out.extend(_conv_shapes("bottom.2", 16 * f, 16 * f, 3, True))
    out.append(("bottom.3.weight", (1,), "prelu"))
    for i, (cin, cout) in enumerate(((16 * f, 8 * f), (8 * f, 4 * f), (4 * f, 2 * f),
                                     (2 * f, f)), start=1):
        out.extend(_conv_shapes(f"up{i}", cin, cout, 2, True))
        if i < 4:
            dbl(f"tconvs{i}", cin, cout, cout, True)
    out.extend(_conv_shapes("tconvs4.0", 2 * f, f, 3, True))
    out.append(("tconvs4.1.weight", (1,), "prelu"))
    out.extend(_conv_shapes("tconvs4.2", f, f, 3, True))
    out.append(("tconvs4.3.weight", (1,), "prelu"))
    out.extend(_conv_shapes("tconvs4.4", f, 3, 1))
    return out


def _unet_double(prefix: str, cin: int, cout: int) -> Shapes:
    out: Shapes = []
    for j, (a, b) in ((0, (cin, cout)), (3, (cout, cout))):
        out.extend(_conv_shapes(f"{prefix}.conv.{j}", a, b, 3))
        bn = f"{prefix}.conv.{j + 1}"
        out += [(f"{bn}.weight", (b,), "bn_weight"), (f"{bn}.bias", (b,), "bn_bias")]
    return out


def unet_shapes() -> Shapes:
    """(name, shape, kind) of every UNet parameter (BatchNorm's affine
    parameters as ``bn_weight`` and ``bn_bias``); the running statistics
    are buffers, see ``unet_buffers``."""
    ch = UNET_CHANNELS
    out = _unet_double("inc.conv", 3, ch[0])
    for i in range(4):
        out += _unet_double(f"down{i + 1}.mpconv.1", ch[i], ch[i + 1])
    for i, (cin, cout) in enumerate(UNET_UPS, start=1):
        out += _conv_shapes(f"up{i}.up", cin // 2, cin // 2, 2, True)
        out += _unet_double(f"up{i}.conv", cin, cout)
    return out + _conv_shapes("outc.conv", ch[0], 3, 1)


def unet_buffers(device=None) -> Dict[str, torch.Tensor]:
    """The BatchNorm buffers of a freshly built UNet: running mean 0,
    running variance 1, no batches tracked."""
    out = {}
    for name, shape, kind in unet_shapes():
        if kind == "bn_weight":
            bn = name[:-len(".weight")]
            out[f"{bn}.running_mean"] = torch.zeros(shape, device=device)
            out[f"{bn}.running_var"] = torch.ones(shape, device=device)
            out[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return out


def param_shapes(network: str, funit: Optional[int] = None) -> Shapes:
    if network == "UtNet":
        return utnet_shapes(funit)
    if network == "UNet":
        return unet_shapes()
    raise ValueError(f"no reference for {network}")


# -- the operations ------------------------------------------------------------

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8_rounding(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under one scale per tensor (its largest
    magnitude mapped to 448, e4m3's largest finite value), back to the
    tensor's type: what an fp8 convolution's operands hold."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class Ops:
    """The convolutions of a forward, with an optional rounding of their
    operands (``None``: float32 as given)."""

    def __init__(self, round_operands: Rounding = None):
        self.r = round_operands

    def _ops(self, x, w):
        return (x, w) if self.r is None else (self.r(x), self.r(w))

    def conv(self, x, w, b, padding: int = 0):
        x, w = self._ops(x, w)
        return F.conv2d(x, w, b, padding=padding)

    def conv_t(self, x, w, b, stride: int = 1):
        x, w = self._ops(x, w)
        return F.conv_transpose2d(x, w, b, stride=stride)


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


def utnet_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, ops: Ops = Ops()) -> torch.Tensor:
    """UtNet on NCHW ``x``; H and W must pass UtNet's size formula."""

    def dbl(name, t, transposed=False):
        c = ops.conv_t if transposed else ops.conv
        t = prelu(c(t, p[f"{name}.0.weight"], p[f"{name}.0.bias"]), p[f"{name}.1.weight"])
        return prelu(c(t, p[f"{name}.2.weight"], p[f"{name}.2.bias"]), p[f"{name}.3.weight"])

    def up(i, t):
        return ops.conv_t(t, p[f"up{i}.weight"], p[f"up{i}.bias"], stride=2)

    l1 = dbl("convs1", F.pad(x, (2, 2, 2, 2), mode="reflect"))
    l2 = dbl("convs2", F.max_pool2d(l1, 2))
    l3 = dbl("convs3", F.max_pool2d(l2, 2))
    l4 = dbl("convs4", F.max_pool2d(l3, 2))
    b = prelu(ops.conv(F.max_pool2d(l4, 2), p["bottom.0.weight"], p["bottom.0.bias"]),
              p["bottom.1.weight"])
    b = prelu(ops.conv_t(b, p["bottom.2.weight"], p["bottom.2.bias"]), p["bottom.3.weight"])
    t = torch.cat([up(1, b), l4], dim=1)
    t = torch.cat([up(2, dbl("tconvs1", t, True)), l3], dim=1)
    t = torch.cat([up(3, dbl("tconvs2", t, True)), l2], dim=1)
    t = torch.cat([up(4, dbl("tconvs3", t, True)), l1], dim=1)
    t = prelu(ops.conv_t(t, p["tconvs4.0.weight"], p["tconvs4.0.bias"]), p["tconvs4.1.weight"])
    t = prelu(ops.conv_t(t, p["tconvs4.2.weight"], p["tconvs4.2.bias"]), p["tconvs4.3.weight"])
    y = ops.conv(t, p["tconvs4.4.weight"], p["tconvs4.4.bias"])
    return y[:, :, 2:-2, 2:-2]


def _bn(p, name, x, train: bool):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    else:
        mean = p[f"{name}.running_mean"].view(1, -1, 1, 1)
        var = p[f"{name}.running_var"].view(1, -1, 1, 1)
    return (x - mean) / torch.sqrt(var + BN_EPS) * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def unet_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool = False,
                 ops: Ops = Ops()) -> torch.Tensor:
    """UNet on NCHW ``x``; ``train``: BatchNorm by the batch's statistics
    (biased variance), else by the running statistics in ``p``."""

    def double(prefix, t):
        for j in (0, 3):
            t = ops.conv(t, p[f"{prefix}.conv.{j}.weight"], p[f"{prefix}.conv.{j}.bias"], 1)
            t = torch.relu(_bn(p, f"{prefix}.conv.{j + 1}", t, train))
        return t

    t = double("inc.conv", x)
    skips = [t]
    for i in range(1, 5):
        t = double(f"down{i}.mpconv.1", F.max_pool2d(t, 2))
        skips.append(t)
    for i in range(1, 5):
        skip = skips[4 - i]
        u = ops.conv_t(t, p[f"up{i}.up.weight"], p[f"up{i}.up.bias"], stride=2)
        dh, dw = skip.shape[2] - u.shape[2], skip.shape[3] - u.shape[3]
        u = F.pad(u, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        t = double(f"up{i}.conv", torch.cat([skip, u], dim=1))
    return torch.sigmoid(ops.conv(t, p["outc.conv.weight"], p["outc.conv.bias"]))


def forward(network: str, p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool = False,
            ops: Ops = Ops()) -> torch.Tensor:
    if network == "UtNet":
        return utnet_forward(p, x, ops)
    if network == "UNet":
        return unet_forward(p, x, train, ops)
    raise ValueError(f"no reference for {network}")


def utnet_valid(cs: int) -> bool:
    """UtNet's size formula: every pool input even, the bottom conv >= 3 px."""
    v = cs
    for _ in range(3):
        if v % 2:
            return False
        v = v // 2 - 4
        if v <= 0:
            return False
    return v % 2 == 0 and v // 2 - 2 > 0
