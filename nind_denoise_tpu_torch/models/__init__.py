"""The port's models, resolved by the names the configs use."""

from __future__ import annotations

import inspect

from .hul import VARIANTS as HUL_DISCS
from .hul import HulDisc
from .hul_gen import Hulb128Net, Hulbs128Net
from .legacy import DnCNN, RedCNN
from .p2p import (MultiscaleDiscriminator, NLayerDiscriminator, PixelDiscriminator,
                  ResnetGenerator)
from .relics import DISCS as RELIC_DISCS
from .relics import NETS as RELIC_NETS
from .relics import RedishCNN
from .third_party import MobileNetV3, deeplabv3_resnet101
from .unet import UNet
from .utnet import UtNet

# the trainer's generators
GENERATORS = {"UtNet": UtNet, "UNet": UNet, "Hulb128Net": Hulb128Net,
              "Hulbs128Net": Hulbs128Net}
# the legacy and pix2pix zoo: registry and inference networks
ZOO = {"DnCNN": DnCNN, "RedCNN": RedCNN, "ResnetGenerator": ResnetGenerator,
       "NLayerDiscriminator": NLayerDiscriminator, "PatchGAN": NLayerDiscriminator,
       "PixelDiscriminator": PixelDiscriminator,
       "MultiscaleDiscriminator": MultiscaleDiscriminator}
ZOO_GENERATORS = ("DnCNN", "RedCNN", "ResnetGenerator")
ZOO_DISCS = ("NLayerDiscriminator", "PatchGAN", "PixelDiscriminator",
             "MultiscaleDiscriminator")
# the relic zoo and the torchvision experiments: registry and inference
# networks (the relic discriminators also run in the cGAN)
RELICS = {**RELIC_NETS, "RedishCNN": RedishCNN}
THIRD_PARTY = {"MobileNetV3": MobileNetV3, "deeplabv3_resnet101": deeplabv3_resnet101}


def get_network(name: str):
    """The ``nn.Module`` class of ``name``: a generator of ``GENERATORS``,
    a network of ``ZOO``, ``RELICS`` or ``THIRD_PARTY``, or ``HulDisc``
    for the four Hul discriminators (built with ``HulDisc(name, ...)``);
    every name of the JAX package's registry. An unknown name raises
    KeyError, as in the JAX package."""
    for table in (GENERATORS, ZOO, RELICS, THIRD_PARTY):
        if name in table:
            return table[name]
    if name in HUL_DISCS:
        return HulDisc
    raise KeyError(f"unknown network {name!r}; available: "
                   f"{sorted([*GENERATORS, *ZOO, *RELICS, *THIRD_PARTY, *HUL_DISCS])}")


def is_discriminator(name: str) -> bool:
    return name in HUL_DISCS or name in ZOO_DISCS or name in RELIC_DISCS


def build(name: str, **kwargs):
    """A fresh ``name`` from torch's RNG, given the keyword arguments its
    constructor takes; the rest are dropped, as the JAX package's ``init``
    functions drop theirs (so the pix2pix discriminators ignore
    ``input_channels`` and ``funit``)."""
    cls = get_network(name)
    params = inspect.signature(cls.__init__).parameters
    kw = {k: v for k, v in kwargs.items() if k in params and k != "network"}
    if cls is HulDisc:
        return HulDisc(name, **kw)
    return cls(**kw)
