"""The port's models, resolved by the names the configs use."""

from __future__ import annotations

from .hul import VARIANTS as HUL_DISCS
from .hul import HulDisc
from .hul_gen import Hulb128Net, Hulbs128Net
from .unet import UNet
from .utnet import UtNet

GENERATORS = {"UtNet": UtNet, "UNet": UNet, "Hulb128Net": Hulb128Net,
              "Hulbs128Net": Hulbs128Net}


def get_network(name: str):
    """The ``nn.Module`` class of ``name``: a generator of ``GENERATORS``,
    or ``HulDisc`` for the four Hul discriminators (built with
    ``HulDisc(name, ...)``). The rest of the JAX package's zoo is not
    ported (ROADMAP item 7)."""
    if name in GENERATORS:
        return GENERATORS[name]
    if name in HUL_DISCS:
        return HulDisc
    raise NotImplementedError(
        f"network {name}: the port has the generators {sorted(GENERATORS)} and "
        f"the Hul discriminators {sorted(HUL_DISCS)}; the rest of the model zoo "
        f"is ROADMAP item 7")
