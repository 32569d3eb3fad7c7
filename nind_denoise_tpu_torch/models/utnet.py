"""UtNet — the production denoising generator, as a PyTorch ``nn.Module``.

The module tree and state_dict names are the reference's
(networks/UtNet.py:13-109; the same tree tests/test_models_parity.py builds):
``convs1..4`` and ``bottom`` are Sequentials of (conv, act, conv, act),
``up1..4`` are ``ConvTranspose2d(k=2, s=2)``, ``tconvs1..4`` Sequentials of
stride-1 3x3 transposed convs, and ``tconvs4`` ends in the 1x1 conv to RGB.

Forward on (N, 3, H, W): reflect-pad by 2, VALID convs, concatenated skips,
crop 2. Encoder level 1 (``convs1`` and the first maxpool) goes through
``ops/enc1.py`` whenever its gate holds; every other conv is a plain
``F.conv2d`` / ``conv_transpose2d`` call. The JAX package's ``apply_fast``
(width folding, composed up-convs) is a TPU layout rewrite and is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import enc1 as enc1_op
from ..ops.conv import crop2, maxpool2x, reflect_pad

_ACTS = {"PReLU": nn.PReLU, "ELU": nn.ELU, "Hardswish": nn.Hardswish}


def check_cs(cs: int) -> None:
    """Validate the size formula (((cs/2-4)/2-4)/2-4)/2-2 (UtNet.py:6-7):
    every pool input must be even and the bottom conv must see >= 3 px."""
    v = cs
    for _ in range(3):
        if v % 2:
            raise ValueError(f"UtNet: invalid tile size {cs} (odd at a pool step)")
        v = v // 2 - 4
        if v <= 0:
            raise ValueError(f"UtNet: tile size {cs} too small")
    if v % 2:
        raise ValueError(f"UtNet: invalid tile size {cs} (odd at a pool step)")
    v = v // 2 - 2
    if v <= 0:
        raise ValueError(f"UtNet: tile size {cs} too small at bottom")


class UtNet(nn.Module):
    """``UtNet(funit, activation)``; forward takes NCHW in [0, 1]-ish."""

    def __init__(self, funit: int = 64, activation: str = "PReLU"):
        super().__init__()
        if activation not in _ACTS:
            raise ValueError(f"unknown activation: {activation}")
        self.activation = activation
        act = _ACTS[activation]
        f = funit

        def dbl(cin, cmid, cout, t=False):
            conv = nn.ConvTranspose2d if t else nn.Conv2d
            return nn.Sequential(conv(cin, cmid, 3), act(),
                                 conv(cmid, cout, 3), act())

        self.convs1 = dbl(3, f, f)
        self.convs2 = dbl(f, 2 * f, 2 * f)
        self.convs3 = dbl(2 * f, 4 * f, 4 * f)
        self.convs4 = dbl(4 * f, 8 * f, 8 * f)
        self.bottom = nn.Sequential(nn.Conv2d(8 * f, 16 * f, 3), act(),
                                    nn.ConvTranspose2d(16 * f, 16 * f, 3), act())
        self.up1 = nn.ConvTranspose2d(16 * f, 8 * f, 2, stride=2)
        self.tconvs1 = dbl(16 * f, 8 * f, 8 * f, t=True)
        self.up2 = nn.ConvTranspose2d(8 * f, 4 * f, 2, stride=2)
        self.tconvs2 = dbl(8 * f, 4 * f, 4 * f, t=True)
        self.up3 = nn.ConvTranspose2d(4 * f, 2 * f, 2, stride=2)
        self.tconvs3 = dbl(4 * f, 2 * f, 2 * f, t=True)
        self.up4 = nn.ConvTranspose2d(2 * f, f, 2, stride=2)
        self.tconvs4 = nn.Sequential(nn.ConvTranspose2d(2 * f, f, 3), act(),
                                     nn.ConvTranspose2d(f, f, 3), act(),
                                     nn.Conv2d(f, 3, 1))

    @staticmethod
    def funit_of(state_dict) -> int:
        return int(state_dict["convs1.0.weight"].shape[0])

    def enc1_gate(self, x: torch.Tensor) -> bool:
        """Whether level 1 runs through the fused enc1 op: PReLU, a
        geometry and width the op takes (even H and W; the CUDA kernel is
        built for funit 64), and no autograd (the kernel has no backward;
        the JAX kernel has no VJP either). Decided before launch, from what
        the call can see — never by catching a failure."""
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or self.convs1[0].weight.requires_grad)
        return (self.activation == "PReLU" and not needs_grad
                and enc1_op.supported(x, self.convs1[0].out_channels))

    def encode1(self, x: torch.Tensor):
        """Level 1 on the unpadded input -> (l1, maxpool2x(l1))."""
        xp = reflect_pad(x, 2)
        if self.enc1_gate(x):
            c0, p0, c1, p1 = self.convs1
            return enc1_op.enc1(xp.contiguous(), c0.weight, c0.bias, p0.weight,
                                c1.weight, c1.bias, p1.weight)
        l1 = self.convs1(xp)
        return l1, maxpool2x(l1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        l1, l2_in = self.encode1(x)
        l2 = self.convs2(l2_in)
        l3 = self.convs3(maxpool2x(l2))
        l4 = self.convs4(maxpool2x(l3))
        t = torch.cat([self.up1(self.bottom(maxpool2x(l4))), l4], dim=1)
        t = torch.cat([self.up2(self.tconvs1(t)), l3], dim=1)
        t = torch.cat([self.up3(self.tconvs2(t)), l2], dim=1)
        t = torch.cat([self.up4(self.tconvs3(t)), l1], dim=1)
        return crop2(self.tconvs4(t), 2)
