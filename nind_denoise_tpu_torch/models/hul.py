"""The Hul discriminator family (cGAN critics) as one ``nn.Module``: the
counterpart of ``nind_denoise_tpu/models/hul.py:29-212``.

* ``Hul112Disc`` — the default ``d_network``: dual standard + dilated conv
  branches with concatenated skips, PReLU (init 0.01) before BatchNorm, two
  stride-3 convs, and a ``decide`` head (2x2 conv, then a 1x1 conv with no
  activation) under a scalar PReLU (the JAX trainer's only output
  activation).
* ``Hulb112Disc`` — the same plan without BatchNorm.
* ``Hull112Disc`` — LeakyReLU (slope 0.01) instead of PReLU.
* ``Hulf112Disc`` — the wide plan, 6 input channels by default.

The architecture is a copy of the JAX package's declarative plan tables.
Every block is an ``nn.Sequential`` of conv -> activation -> BatchNorm
(the decide head's last conv has no activation; a LeakyReLU occupies its
slot like a PReLU), so the state_dict names are the reference's,
``<block>.<seq_idx>.<param>`` and ``out_activation.weight``, and its ``.pt``
files load directly. BatchNorm keeps torch's semantics (eps 1e-5, momentum
0.1, unbiased variance in the running stats), which the JAX package's
``models/norm.py`` reproduces.

``forward(x, frozen=False)`` in train mode updates the running stats (the
discriminator's own step). ``frozen=True`` is ``models/norm.layer``'s
frozen forward: the batch's statistics in either mode, no buffer changed,
no gradient to the module (the generator's fooling term). Eval mode
without ``frozen`` normalizes with the running stats.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from . import norm

# conv spec: (cin_mult, cout_mult, kernel, dilation, stride, bias, bn);
# cin_mult None means the raw input's channels
Spec = Tuple[Optional[int], int, int, int, int, bool, bool]

_STD_PLAN: Dict[str, List[Spec]] = {   # Hul112 / Hulb112 / Hull112
    "enc112to108std": [(None, 2, 3, 1, 1, True, False), (2, 2, 3, 1, 1, True, False)],
    "enc112to108dil": [(None, 2, 3, 2, 1, True, False)],
    "enc108to104std": [(4, 2, 3, 1, 1, False, True), (2, 2, 3, 1, 1, False, True)],
    "enc108to104dil": [(4, 2, 3, 2, 1, False, True)],
    "enc104to102std": [(4, 4, 3, 1, 1, False, True)],
    "enc112to102dil": [(None, 2, 3, 5, 1, False, True)],
    "enc102to34str": [(6, 6, 3, 1, 3, False, True)],
    "enc34to30std": [(6, 4, 3, 1, 1, False, True), (4, 4, 3, 1, 1, False, True)],
    "enc34to30dil": [(6, 4, 3, 2, 1, False, True)],
    "enc30to26std": [(8, 4, 3, 1, 1, False, True), (4, 4, 3, 1, 1, False, True)],
    "enc30to26dil": [(8, 4, 3, 2, 1, False, True)],
    "enc26to22std": [(8, 4, 3, 1, 1, False, True), (4, 4, 3, 1, 1, False, True)],
    "enc26to22dil": [(8, 4, 3, 2, 1, False, True)],
    "enc22to18std": [(8, 4, 3, 1, 1, False, True), (4, 4, 3, 1, 1, False, True)],
    "enc22to18dil": [(8, 4, 3, 2, 1, False, True)],
    "enc18to6str": [(8, 8, 3, 1, 3, False, True)],
    "enc6to2std": [(8, 6, 3, 1, 1, False, True), (6, 3, 3, 1, 1, False, False)],
    "enc6to2dil": [(8, 3, 3, 2, 1, False, False)],
    "decide": [(6, 1, 2, 1, 1, True, False), (1, 0, 1, 1, 1, True, False)],
}

_WIDE_PLAN: Dict[str, List[Spec]] = {  # Hulf112
    "enc112to108std": [(None, 2, 3, 1, 1, True, False), (2, 2, 3, 1, 1, True, False)],
    "enc112to108dil": [(None, 2, 3, 2, 1, True, False)],
    "enc108to104std": [(4, 4, 3, 1, 1, False, True), (4, 4, 3, 1, 1, False, True)],
    "enc108to104dil": [(4, 4, 3, 2, 1, False, True)],
    "enc104to102std": [(8, 8, 3, 1, 1, False, True)],
    "enc112to102dil": [(None, 2, 3, 5, 1, False, True)],
    "enc102to34str": [(10, 10, 3, 1, 3, False, True)],
    "enc34to30std": [(10, 10, 3, 1, 1, False, True), (10, 10, 3, 1, 1, False, True)],
    "enc34to30dil": [(10, 10, 3, 2, 1, False, True)],
    "enc30to26std": [(20, 20, 3, 1, 1, False, True), (20, 10, 3, 1, 1, False, True)],
    "enc30to26dil": [(20, 10, 3, 2, 1, False, True)],
    "enc26to22std": [(20, 20, 3, 1, 1, False, True), (20, 10, 3, 1, 1, False, True)],
    "enc26to22dil": [(20, 10, 3, 2, 1, False, True)],
    "enc22to18std": [(20, 20, 3, 1, 1, False, True), (20, 12, 3, 1, 1, False, True)],
    "enc22to18dil": [(20, 12, 3, 2, 1, False, True)],
    "enc18to6str": [(24, 24, 3, 1, 3, False, True)],
    "enc6to2std": [(24, 24, 3, 1, 1, False, True), (24, 12, 3, 1, 1, False, False)],
    "enc6to2dil": [(24, 12, 3, 2, 1, False, False)],
    "decide": [(24, 6, 2, 1, 1, True, False), (6, 0, 1, 1, 1, True, False)],
}

# network name -> (plan, BatchNorm, activation, default input channels)
VARIANTS = {
    "Hul112Disc": (_STD_PLAN, True, "PReLU", 3),
    "Hulb112Disc": (_STD_PLAN, False, "PReLU", 3),
    "Hull112Disc": (_STD_PLAN, True, "LeakyReLU", 3),
    "Hulf112Disc": (_WIDE_PLAN, True, "PReLU", 6),
}


def layer_slots(network: str):
    """For every conv of ``network``'s plan: (block, index in the plan, its
    spec, Sequential index of the conv, of its activation or None, of its
    BatchNorm or None) — the reference's Sequential walk, which the
    state_dict names follow."""
    plan, use_bn, _, _ = VARIANTS[network]
    for bname, specs in plan.items():
        idx = 0
        for li, spec in enumerate(specs):
            conv, idx = idx, idx + 1
            act = None
            if not (bname == "decide" and li == len(specs) - 1):
                act, idx = idx, idx + 1
            bn = None
            if spec[6] and use_bn:
                bn, idx = idx, idx + 1
            yield bname, li, spec, conv, act, bn


class HulDisc(nn.Module):
    """``HulDisc(network, input_channels, funit)``; forward
    takes NCHW (112 x 112 crops canonically, 184 in the default trainer
    config) and returns the prediction map."""

    def __init__(self, network: str = "Hul112Disc", input_channels: Optional[int] = None,
                 funit: int = 32):
        super().__init__()
        if network not in VARIANTS:
            raise ValueError(f"unknown Hul discriminator: {network}")
        plan, _, activation, default_in = VARIANTS[network]
        self.network = network
        cin_raw = default_in if input_channels is None else int(input_channels)
        blocks: Dict[str, list] = {b: [] for b in plan}
        for bname, _, spec, _, act, bn in layer_slots(network):
            cin_m, cout_m, k, dil, stride, bias, _ = spec
            cin = cin_raw if cin_m is None else cin_m * funit
            cout = max(1, cout_m * funit) if cout_m else 1
            seq = blocks[bname]
            seq.append(nn.Conv2d(cin, cout, k, stride=stride, dilation=dil, bias=bias))
            if act is not None:
                seq.append(nn.PReLU(init=0.01) if activation == "PReLU" else nn.LeakyReLU(0.01))
            if bn is not None:
                seq.append(nn.BatchNorm2d(cout))
        for bname, seq in blocks.items():
            self.add_module(bname, nn.Sequential(*seq))
        self.out_activation = nn.PReLU(init=0.01)

    def forward(self, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        def blk(name, t):
            return norm.sequential(getattr(self, name), t, frozen)

        def cat(a, b):
            return torch.cat([a, b], dim=1)

        layer = cat(blk("enc112to108std", x), blk("enc112to108dil", x))
        layer = cat(blk("enc108to104std", layer), blk("enc108to104dil", layer))
        layer = cat(blk("enc104to102std", layer), blk("enc112to102dil", x))
        layer = blk("enc102to34str", layer)
        for lvl in ("34to30", "30to26", "26to22", "22to18"):
            layer = cat(blk(f"enc{lvl}std", layer), blk(f"enc{lvl}dil", layer))
        layer = blk("enc18to6str", layer)
        layer = cat(blk("enc6to2std", layer), blk("enc6to2dil", layer))
        layer = blk("decide", layer)
        return norm.layer(self.out_activation, layer, frozen)

    @staticmethod
    def shape_of(state_dict) -> Tuple[int, int]:
        """(input channels, funit) of a state_dict, from its first conv."""
        w = state_dict["enc112to108std.0.weight"]
        return int(w.shape[1]), int(w.shape[0]) // 2
