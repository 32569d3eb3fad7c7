"""The port's models, resolved by the names the configs use."""

from __future__ import annotations

import inspect

from .hul import VARIANTS as HUL_DISCS
from .hul import HulDisc
from .hul_gen import Hulb128Net, Hulbs128Net
from .legacy import DnCNN, RedCNN
from .p2p import (MultiscaleDiscriminator, NLayerDiscriminator, PixelDiscriminator,
                  ResnetGenerator)
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
# the JAX package's relic zoo and torchvision experiments, not ported yet
NOT_PORTED = ("RedishCNN", "HunkyDisc", "HunkyNet", "HunNet", "HuNet", "HuDisc",
              "Hul144Disc", "Hul128Net", "Hul160Net", "HulNet", "MobileNetV3",
              "deeplabv3_resnet101")


def get_network(name: str):
    """The ``nn.Module`` class of ``name``: a generator of ``GENERATORS``,
    a network of ``ZOO``, or ``HulDisc`` for the four Hul discriminators
    (built with ``HulDisc(name, ...)``). The relic zoo and the torchvision
    networks raise NotImplementedError (ROADMAP item 7.3); an unknown name
    raises KeyError, as in the JAX package."""
    if name in GENERATORS:
        return GENERATORS[name]
    if name in ZOO:
        return ZOO[name]
    if name in HUL_DISCS:
        return HulDisc
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"network {name}: the relic zoo and the torchvision networks are not "
            f"ported yet (ROADMAP item 7.3)")
    raise KeyError(f"unknown network {name!r}; available: "
                   f"{sorted([*GENERATORS, *ZOO, *HUL_DISCS, *NOT_PORTED])}")


def is_discriminator(name: str) -> bool:
    return name in HUL_DISCS or name in ZOO_DISCS


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
