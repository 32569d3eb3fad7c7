"""The legacy UNet generator as a PyTorch ``nn.Module``: the counterpart of
``nind_denoise_tpu/models/unet.py``.

Double blocks (3x3 SAME conv + BatchNorm + ReLU, twice), a
64->128->256->512->512 encoder with 2x2 max-pool downs, 2x2 stride-2
transposed-conv ups, each centre-padded to its skip (the extra row at the
bottom, the extra column on the right) and concatenated after it, a 1x1
``outc`` conv and a sigmoid; ``find_noise`` returns ``input - sigmoid``.

The module tree is the reference's (networks/nnModules.py:104-210), so its
``.pt`` files load directly: ``inc.conv.conv.{0,1,3,4}``,
``down{i}.mpconv.1.conv.*``, ``up{i}.up``, ``up{i}.conv.conv.*`` and
``outc.conv``.

BatchNorm keeps torch's semantics (eps 1e-5, momentum 0.1, unbiased
variance in the running stats), which the JAX package's ``models/norm.py``
reproduces, and always computes in float32: a bf16 UNet (``cast_convs``)
runs its convs in bf16 and normalizes in fp32 with fp32 parameters and
running stats, casting back, as the JAX package does.

``forward(x, frozen=False)``: in train mode the batch's statistics
normalize and update the running stats; in eval mode the running stats
normalize; ``frozen=True`` normalizes by the batch's statistics in either
mode and changes no buffer (the JAX trainer's ``infer``, which applies
``train=True`` and drops the new state, and the recomputation under
``--remat``, which must not update the stats a second time). In a
data-parallel run both take the global batch's statistics (the module's
own ``normalize``, ``norm.normalize_fn``); in one band of the trainer's
sharded whole-image test (``data_parallel.owned_rows``) the frozen path
takes those of every rank's owned rows, the whole image's.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import maxpool2x
from .norm import normalize_fn

CHANNELS = (64, 128, 256, 512, 512)


class DoubleConv(nn.Module):
    """(conv 3x3 SAME -> BN -> ReLU) x 2, under ``.conv``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU())


class InConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))


class Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin // 2, cin // 2, 2, stride=2)
        self.conv = DoubleConv(cin, cout)


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)


def pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Centre-pad x1 spatially to x2's H, W: (d // 2, d - d // 2)."""
    dh = x2.shape[2] - x1.shape[2]
    dw = x2.shape[3] - x1.shape[3]
    if dh == 0 and dw == 0:
        return x1
    return F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


class UNet(nn.Module):
    """``UNet(n_channels, n_classes, find_noise)``; forward takes NCHW."""

    def __init__(self, n_channels: int = 3, n_classes: int = 3, find_noise: bool = False):
        super().__init__()
        ch = CHANNELS
        self.find_noise = find_noise
        self.inc = InConv(n_channels, ch[0])
        for i in range(4):
            setattr(self, f"down{i + 1}", Down(ch[i], ch[i + 1]))
        for i, (cin, cout) in enumerate(zip((1024, 512, 256, 128), (256, 128, 64, 64))):
            setattr(self, f"up{i + 1}", Up(cin, cout))
        self.outc = OutConv(ch[0], n_classes)
        self._frozen = False

    def cast_convs(self, dtype: torch.dtype) -> "UNet":
        """Cast the conv weights to ``dtype`` and leave BatchNorm in fp32
        (the JAX package's mixed precision); returns self."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype)
        return self

    @contextlib.contextmanager
    def frozen_stats(self):
        """Within: every forward is ``frozen`` (see the module doc)."""
        prev, self._frozen = self._frozen, True
        try:
            yield
        finally:
            self._frozen = prev

    def _bn(self, m: nn.BatchNorm2d, x: torch.Tensor, frozen: bool) -> torch.Tensor:
        xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        mean, var = m.running_mean, m.running_var
        if frozen:
            # the batch's statistics, updating copies: the same op as a
            # train-mode forward, so a recomputation saves what it saved
            mean, var = mean.clone(), var.clone()
        y = normalize_fn(m)(xf, mean, var, m.weight, m.bias, self.training or frozen,
                            m.momentum, m.eps)
        return y.to(x.dtype)

    def _double(self, block: DoubleConv, x: torch.Tensor, frozen: bool) -> torch.Tensor:
        c0, bn0, _, c1, bn1, _ = block.conv
        x = torch.relu(self._bn(bn0, c0(x), frozen))
        return torch.relu(self._bn(bn1, c1(x), frozen))

    def forward(self, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        frozen = frozen or self._frozen
        t = self._double(self.inc.conv, x, frozen)
        skips = [t]
        for i in range(4):
            t = self._double(getattr(self, f"down{i + 1}").mpconv[1], maxpool2x(t), frozen)
            skips.append(t)
        for i in range(4):
            up = getattr(self, f"up{i + 1}")
            skip = skips[3 - i]
            t = torch.cat([skip, pad_to_match(up.up(t), skip)], dim=1)
            t = self._double(up.conv, t, frozen)
        y = torch.sigmoid(self.outc.conv(t))
        return x - y if self.find_noise else y
