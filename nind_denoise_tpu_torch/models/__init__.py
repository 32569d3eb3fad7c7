"""The port's models, resolved by the names the configs use."""

from __future__ import annotations

from .hul import VARIANTS as HUL_DISCS
from .hul import HulDisc
from .utnet import UtNet


def get_network(name: str):
    """The ``nn.Module`` class of ``name``: ``UtNet``, or ``HulDisc`` for
    the four Hul discriminators (built with ``HulDisc(name, ...)``). The
    rest of the JAX package's zoo is not ported (ROADMAP item 7)."""
    if name == "UtNet":
        return UtNet
    if name in HUL_DISCS:
        return HulDisc
    raise NotImplementedError(
        f"network {name}: the port has UtNet and the Hul discriminators "
        f"{sorted(HUL_DISCS)}; the rest of the model zoo is ROADMAP item 7")
