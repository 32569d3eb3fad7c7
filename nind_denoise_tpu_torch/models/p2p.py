"""The pix2pix networks as ``nn.Module``s: the counterparts of
``nind_denoise_tpu/models/p2p.py``, in upstream pix2pix's module layout.

* ``ResnetGenerator``: a reflect-padded 7x7 conv, two stride-2 3x3 down
  convs, ``n_blocks`` residual blocks (reflect-padded 3x3 convs), two
  ``ConvTranspose2d(k3, s2, p1, output_padding=1)`` ups and a reflect-padded
  7x7 conv under tanh, each conv but the last followed by its norm and ReLU.
  One ``nn.Sequential`` under ``model``; a block's convs sit in its
  ``conv_block``. Every conv has a bias, also before a norm, as in the JAX
  package (upstream drops it before BatchNorm).
* ``NLayerDiscriminator`` (PatchGAN): 4x4 convs padded 2, stride 2 but the
  last of the ladder, the channels doubled up to an absolute 512, no norm
  on layer 0, LeakyReLU(0.2), a 1-channel 4x4 output conv, an optional
  sigmoid; ``model`` is the Sequential.
* ``PixelDiscriminator``: 1x1 convs 6 -> ndf -> 2 ndf (norm) -> 1 under
  ``net``.
* ``MultiscaleDiscriminator``: ``num_D`` PatchGANs ``d0 ... d{num_D-1}``
  over an image pyramid, ``AvgPool2d(3, 2, 1, count_include_pad=False)``
  between scales; critic ``num_D - 1`` sees the full resolution, and the
  forward returns the maps from the full resolution down.

Norm: ``batch`` (``nn.BatchNorm2d``, torch's defaults) or ``instance``
(affine-free, no running stats). The discriminators'
``forward(x, frozen=False)`` takes ``models/norm.layer``'s frozen forward
for the cGAN's fooling term. ``define_G`` and ``define_D`` are the
reference's factories.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from . import norm

DOWNS = 2  # the ResnetGenerator's stride-2 downs (and ups)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, norm_type: str = "batch"):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), norm.norm_layer(norm_type, dim),
            nn.ReLU(),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), norm.norm_layer(norm_type, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, norm_type: str = "batch"):
        super().__init__()
        seq = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7),
               norm.norm_layer(norm_type, ngf), nn.ReLU()]
        for i in range(DOWNS):
            c = ngf * 2 ** i
            seq += [nn.Conv2d(c, 2 * c, 3, stride=2, padding=1),
                    norm.norm_layer(norm_type, 2 * c), nn.ReLU()]
        seq += [ResnetBlock(ngf * 2 ** DOWNS, norm_type) for _ in range(n_blocks)]
        for i in range(DOWNS):
            c = ngf * 2 ** (DOWNS - i)
            seq += [nn.ConvTranspose2d(c, c // 2, 3, stride=2, padding=1, output_padding=1),
                    norm.norm_layer(norm_type, c // 2), nn.ReLU()]
        seq += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*seq)

    @staticmethod
    def config_of(sd) -> dict:
        """Constructor arguments of a state_dict (instance norm where it
        holds no BatchNorm)."""
        last = max(int(k.split(".")[1]) for k in sd if k.startswith("model."))
        w, out = sd["model.1.weight"], sd[f"model.{last}.weight"]
        blocks = {k.split(".")[1] for k in sd if ".conv_block." in k}
        return {"input_nc": int(w.shape[1]), "output_nc": int(out.shape[0]),
                "ngf": int(w.shape[0]), "n_blocks": len(blocks),
                "norm_type": "batch" if "model.2.weight" in sd else "instance"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class NLayerDiscriminator(nn.Module):
    """The PatchGAN critic (registered under both names)."""

    def __init__(self, input_nc: int = 6, ndf: int = 64, n_layers: int = 3,
                 norm_type: str = "batch", use_sigmoid: bool = False):
        super().__init__()
        seq = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=2), nn.LeakyReLU(0.2)]
        c = ndf
        for i in range(1, n_layers + 1):
            cout = min(c * 2, 512)
            seq += [nn.Conv2d(c, cout, 4, stride=2 if i < n_layers else 1, padding=2),
                    norm.norm_layer(norm_type, cout), nn.LeakyReLU(0.2)]
            c = cout
        seq.append(nn.Conv2d(c, 1, 4, padding=2))
        if use_sigmoid:
            seq.append(nn.Sigmoid())
        self.model = nn.Sequential(*seq)

    @staticmethod
    def config_of(sd, prefix: str = "") -> dict:
        """Constructor arguments of a state_dict (no sigmoid; instance norm
        where it holds no BatchNorm)."""
        w = sd[prefix + "model.0.weight"]
        convs = sum(k.startswith(prefix + "model.") and k.endswith(".weight")
                    and len(sd[k].shape) == 4 for k in sd)
        return {"input_nc": int(w.shape[1]), "ndf": int(w.shape[0]), "n_layers": convs - 2,
                "norm_type": "batch" if prefix + "model.3.weight" in sd else "instance"}

    def forward(self, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        return norm.sequential(self.model, x, frozen)


class PixelDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 6, ndf: int = 64, norm_type: str = "batch",
                 use_sigmoid: bool = False):
        super().__init__()
        seq = [nn.Conv2d(input_nc, ndf, 1), nn.LeakyReLU(0.2), nn.Conv2d(ndf, 2 * ndf, 1),
               norm.norm_layer(norm_type, 2 * ndf), nn.LeakyReLU(0.2), nn.Conv2d(2 * ndf, 1, 1)]
        if use_sigmoid:
            seq.append(nn.Sigmoid())
        self.net = nn.Sequential(*seq)

    @staticmethod
    def config_of(sd) -> dict:
        w = sd["net.0.weight"]
        return {"input_nc": int(w.shape[1]), "ndf": int(w.shape[0]),
                "norm_type": "batch" if "net.3.weight" in sd else "instance"}

    def forward(self, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        return norm.sequential(self.net, x, frozen)


def downsample(x: torch.Tensor) -> torch.Tensor:
    """The pyramid's step: torch ``AvgPool2d(3, 2, 1, count_include_pad=False)``."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


class MultiscaleDiscriminator(nn.Module):
    """``num_D`` PatchGAN critics over an avg-pooled image pyramid; the
    forward returns a list of prediction maps, full resolution first."""

    def __init__(self, input_nc: int = 6, ndf: int = 64, n_layers: int = 3, num_D: int = 3,
                 norm_type: str = "batch"):
        super().__init__()
        self.num_D = num_D
        for d in range(num_D):
            self.add_module(f"d{d}", NLayerDiscriminator(input_nc, ndf, n_layers, norm_type))

    @staticmethod
    def config_of(sd) -> dict:
        num_d = len({k.split(".")[0] for k in sd})
        return {**NLayerDiscriminator.config_of(sd, "d0."), "num_D": num_d}

    def forward(self, x: torch.Tensor, frozen: bool = False) -> List[torch.Tensor]:
        outs = []
        for i in range(self.num_D):
            outs.append(getattr(self, f"d{self.num_D - 1 - i}")(x, frozen))
            if i < self.num_D - 1:
                x = downsample(x)
        return outs


def define_G(input_nc: int, output_nc: int, ngf: int, norm: str = "batch",
             net_type: str = "Resnet", **kwargs) -> nn.Module:
    """The generator factory (``p2p_networks.define_G``): ``Resnet`` is the
    ResnetGenerator; any other ``net_type`` is built by ``models.build``
    with ``kwargs``."""
    from . import build

    if net_type == "Resnet":
        return ResnetGenerator(input_nc, output_nc, ngf, norm_type=norm, **kwargs)
    return build(net_type, **kwargs)


def define_D(input_nc: int, ndf: int, netD: str, n_layers_D: int = 3, norm: str = "batch",
             **kwargs) -> nn.Module:
    """The discriminator factory (``p2p_networks.define_D``): ``basic`` (a
    3-layer PatchGAN), ``n_layers``, ``pixel``, ``multiscale``, or a
    discriminator of the registry built with ``input_channels`` and
    ``kwargs``."""
    from . import build

    if netD == "basic":
        return NLayerDiscriminator(input_nc, ndf, 3, norm)
    if netD == "n_layers":
        return NLayerDiscriminator(input_nc, ndf, n_layers_D, norm)
    if netD == "pixel":
        return PixelDiscriminator(input_nc, ndf, norm)
    if netD == "multiscale":
        return MultiscaleDiscriminator(input_nc, ndf, n_layers_D, norm_type=norm)
    return build(netD, input_channels=input_nc, **kwargs)
