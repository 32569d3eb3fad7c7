"""The Hul generators Hulb128Net and Hulbs128Net as one ``nn.Module``: the
counterpart of ``nind_denoise_tpu/models/hul_gen.py``.

A dense-concat encoder/decoder with dual standard and dilated conv
branches, two stride-3 downsampling convs (the canonical 128 px input
runs 128 -> 114 -> 38 -> 30 -> 10 -> 2), a mirrored transposed-conv
decoder (3x3 plain, dilation 2 and stride 3) with skip concats at every
level, and a head of a 3x3 and a 1x1 transposed conv under an optional
output activation (PReLU(0.01), ReLU, Sigmoid or none). Hulb128Net puts a
PReLU (init 0.01) after every other conv, Hulbs128Net a SELU.

Valid input sizes: (size - 14) and the stages after it must divide by 3;
128 is the reference's training crop ("BS 12").

Every block is an ``nn.Sequential`` of conv -> activation (the head's last
conv has none), so the state_dict names are the reference's,
``<block>.<seq_idx>.<param>`` and ``activation.weight``, and its ``.pt``
files load directly. The JAX package lowers its transposed convs to plain
convs over flipped kernels; here they are ``nn.ConvTranspose2d``, and
``params_io``'s weight maps make the two compute the same function.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# layer spec: (cin_mult, cout_mult, type, bias); types: c = conv3 VALID,
# d2/d5 = dilated conv, s3 = stride-3 conv, t = tconv3, td2 = dilated
# tconv3, ts3 = stride-3 tconv3, t1 = 1x1 tconv; cin_mult None = the raw
# input's channels; cout_mult 0 = RGB
_PLAN: Dict[str, List[Tuple[Optional[int], int, str, bool]]] = {
    # encoder
    "enc128to126std": [(None, 2, "c", True)],
    "enc126to122std": [(2, 2, "c", False), (2, 2, "c", False)],
    "enc122to118std": [(4, 2, "c", False), (2, 2, "c", False)],
    "enc126to122dil": [(2, 2, "d2", False)],
    "enc122to118dil": [(4, 2, "d2", False)],
    "enc128to118dil": [(None, 2, "d5", False)],
    "enc118to114std": [(6, 2, "c", False), (2, 2, "c", False)],
    "enc118to114dil": [(6, 2, "d2", False)],
    "enc114to38str": [(4, 4, "s3", False)],
    "enc38to34std": [(4, 2, "c", False), (2, 2, "c", False)],
    "enc34to30std": [(4, 2, "c", False), (2, 2, "c", False)],
    "enc38to34dil": [(4, 2, "d2", False)],
    "enc34to30dil": [(4, 2, "d2", False)],
    "enc30to10str": [(4, 4, "s3", False)],
    "enc10to6std": [(4, 3, "c", False), (3, 3, "c", False)],
    "enc6to2std": [(6, 6, "c", False), (6, 6, "c", False)],
    "enc10to6dil": [(4, 3, "d2", False)],
    "enc6to2dil": [(6, 6, "d2", False)],
    # decoder
    "dec2to6std": [(12, 3, "t", False), (3, 3, "t", False)],
    "dec6to10std": [(12, 3, "t", False), (3, 3, "t", False)],
    "dec2to6dil": [(12, 3, "td2", False)],
    "dec6to10dil": [(12, 3, "td2", False)],
    "dec10to30str": [(10, 5, "ts3", False)],
    "dec30to34std": [(9, 3, "t", False), (3, 3, "t", False)],
    "dec30to34dil": [(9, 3, "td2", False)],
    "dec34to38std": [(10, 3, "t", False), (3, 3, "t", False)],
    "dec34to38dil": [(10, 3, "td2", False)],
    "dec38to114str": [(10, 4, "ts3", False)],
    "dec114to118std": [(8, 3, "t", False), (3, 3, "t", False)],
    "dec114to118dil": [(8, 3, "td2", False)],
    "dec118to122std": [(12, 3, "t", False), (3, 3, "t", False)],
    "dec118to122dil": [(12, 3, "td2", False)],
    "dec122to126std": [(10, 3, "t", False), (3, 3, "t", False)],
    "dec122to126dil": [(10, 3, "td2", False)],
    "dec126to128std": [(8, 2, "t", True), (2, 0, "t1", True)],
}
HEAD = "dec126to128std"
CONV_TYPES = ("c", "d2", "d5", "s3")
# network name -> the activation between convs
VARIANTS = {"Hulb128Net": "PReLU", "Hulbs128Net": "SELU"}
FINAL_ACTIVATIONS = ("PReLU", "ReLU", "Sigmoid", "None", None)


def _layer(ltype: str, cin: int, cout: int, bias: bool) -> nn.Module:
    if ltype in CONV_TYPES:
        dil = {"d2": 2, "d5": 5}.get(ltype, 1)
        return nn.Conv2d(cin, cout, 3, stride=3 if ltype == "s3" else 1,
                         dilation=dil, bias=bias)
    if ltype == "t1":
        return nn.ConvTranspose2d(cin, cout, 1, bias=bias)
    return nn.ConvTranspose2d(cin, cout, 3, stride=3 if ltype == "ts3" else 1,
                              dilation=2 if ltype == "td2" else 1, bias=bias)


def layer_slots():
    """For every layer of the plan: (block, index in the plan, its type,
    Sequential index of the layer, of its activation or None) — the
    reference's Sequential walk, which the state_dict names follow."""
    for bname, specs in _PLAN.items():
        for li, (_, _, ltype, _) in enumerate(specs):
            last = bname == HEAD and li == len(specs) - 1
            yield bname, li, ltype, 2 * li, None if last else 2 * li + 1


class HulGen(nn.Module):
    """``HulGen(network, funit, activation, in_channels)``; forward takes
    NCHW and returns the same spatial size. ``activation`` is the output
    activation."""

    def __init__(self, network: str = "Hulb128Net", funit: int = 32,
                 activation: Optional[str] = "PReLU", in_channels: int = 3):
        super().__init__()
        if network not in VARIANTS:
            raise ValueError(f"unknown Hul generator: {network}")
        if activation not in FINAL_ACTIVATIONS:
            raise ValueError(f"unknown output activation: {activation}")
        self.network = network
        self.final_activation = activation
        act = VARIANTS[network]
        for bname, specs in _PLAN.items():
            seq = []
            for li, (cin_m, cout_m, ltype, bias) in enumerate(specs):
                cin = in_channels if cin_m is None else cin_m * funit
                cout = max(1, cout_m * funit) if cout_m else 3
                seq.append(_layer(ltype, cin, cout, bias))
                if not (bname == HEAD and li == len(specs) - 1):
                    seq.append(nn.PReLU(init=0.01) if act == "PReLU" else nn.SELU())
            self.add_module(bname, nn.Sequential(*seq))
        if activation == "PReLU":
            self.activation = nn.PReLU(init=0.01)

    @staticmethod
    def funit_of(state_dict) -> int:
        return int(state_dict["enc128to126std.0.weight"].shape[0]) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def B(name, t):
            return getattr(self, name)(t)

        def cat(*ts):
            return torch.cat(ts, dim=1)

        l126 = B("enc128to126std", x)
        l122 = cat(B("enc126to122std", l126), B("enc126to122dil", l126))
        l118 = cat(B("enc122to118std", l122), B("enc122to118dil", l122),
                   B("enc128to118dil", x))
        l114 = cat(B("enc118to114std", l118), B("enc118to114dil", l118))
        l38 = B("enc114to38str", l114)
        l34 = cat(B("enc38to34std", l38), B("enc38to34dil", l38))
        l30 = cat(B("enc34to30std", l34), B("enc34to30dil", l34))
        l10 = B("enc30to10str", l30)
        l6 = cat(B("enc10to6std", l10), B("enc10to6dil", l10))
        l2 = cat(B("enc6to2std", l6), B("enc6to2dil", l6))
        l6 = cat(l6, B("dec2to6std", l2), B("dec2to6dil", l2))
        l10 = cat(l10, B("dec6to10std", l6), B("dec6to10dil", l6))
        l30 = cat(l30, B("dec10to30str", l10))
        l34 = cat(l34, B("dec30to34std", l30), B("dec30to34dil", l30))
        l38 = cat(l38, B("dec34to38std", l34), B("dec34to38dil", l34))
        l114 = cat(l114, B("dec38to114str", l38))
        l118 = cat(l118, B("dec114to118std", l114), B("dec114to118dil", l114))
        l122 = cat(l122, B("dec118to122std", l118), B("dec118to122dil", l118))
        l126 = cat(l126, B("dec122to126std", l122), B("dec122to126dil", l122))
        res = B(HEAD, l126)
        if self.final_activation in (None, "None"):
            return res
        if self.final_activation == "ReLU":
            return torch.relu(res)
        if self.final_activation == "Sigmoid":
            return torch.sigmoid(res)
        return F.prelu(res, self.activation.weight)


class Hulb128Net(HulGen):
    """PReLU(0.01) between convs (Hul.py:12-250)."""

    def __init__(self, funit: int = 32, activation: Optional[str] = "PReLU",
                 in_channels: int = 3):
        super().__init__("Hulb128Net", funit, activation, in_channels)


class Hulbs128Net(HulGen):
    """SELU between convs (Hul.py:421-658)."""

    def __init__(self, funit: int = 32, activation: Optional[str] = "PReLU",
                 in_channels: int = 3):
        super().__init__("Hulbs128Net", funit, activation, in_channels)
