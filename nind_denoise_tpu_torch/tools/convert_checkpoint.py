"""convert-checkpoint — a torch ``.pt`` state_dict to the JAX package's
``.npz`` format and back, offline: the counterpart of
``nind_denoise_tpu/tools/convert_checkpoint.py``.

Forward (``.pt`` -> ``.npz``): the state_dict is read with ``torch.load``
and mapped by ``models/params_io`` to the JAX layout (HWIO kernels,
transposed convs as plain convs over flipped kernels, (I, 4*O) up-conv
matrices, scalar PReLU ``a``, BatchNorm ``scale/bias`` and ``mean/var``
state). UtNet and the Hul generators write their params tree; UNet, the
Hul discriminators and MobileNetV3 (torchvision's
``lraspp_mobilenet_v3_large`` state_dict, or the reference wrapper's under
``net.``) a ``{"params", "state"}`` tree.

Reverse (``.npz`` source): the params (and BatchNorm state, which UNet and
the Hul discriminators need) back to the reference's state_dict layout,
written with ``torch.save``.

Both directions are exact. Networks: UtNet, UNet, Hul112Disc, Hulb112Disc,
Hull112Disc, Hulf112Disc, Hulb128Net, Hulbs128Net, and MobileNetV3 forward
only (the JAX package has no export for it). The legacy, pix2pix and relic
zoo has no torch mapping, as in the JAX package.

    python -m nind_denoise_tpu_torch.tools.convert_checkpoint generator_650.pt \\
        generator_650.npz --network UtNet
    python -m nind_denoise_tpu_torch.tools.convert_checkpoint mine_120.npz \\
        mine_120.pt --network UNet
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models import GENERATORS, params_io
from ..models.hul import VARIANTS

HUL_DISCS = tuple(VARIANTS)
NETWORKS = tuple(GENERATORS) + HUL_DISCS


def _check(network: str, reverse: bool = False) -> None:
    if network == "MobileNetV3":
        if reverse:
            raise NotImplementedError(
                "torch export for MobileNetV3: the reverse direction supports "
                f"{', '.join(NETWORKS)}, as in the JAX package")
        return
    if network not in NETWORKS:
        # the legacy and pix2pix zoo among them: the JAX package's
        # torch_import and torch_export have no mapping for it either
        raise NotImplementedError(f"torch import/export for {network}: the network has no "
                                  f"torch mapping (supported: {', '.join(NETWORKS)})")


def convert(src: str, dst: str, network: str) -> str:
    """``.pt`` state_dict -> JAX-layout ``.npz``; returns ``dst``."""
    _check(network)
    sd = torch.load(src, map_location="cpu", weights_only=True)
    if network in HUL_DISCS:
        params, state = params_io.hul_jax_from_state_dict(sd, network)
    else:
        params, state = params_io.generator_jax_from_state_dict(network, sd)
    params_io.save({"params": params, "state": state} if state is not None else params, dst)
    return dst


def convert_reverse(src: str, dst: str, network: str) -> str:
    """JAX-layout ``.npz`` -> the reference's ``.pt`` state_dict; returns
    ``dst``."""
    _check(network, reverse=True)
    tree = params_io.load_npz(src)
    params = tree["params"] if isinstance(tree, dict) and "params" in tree else tree
    state = tree.get("state") if isinstance(tree, dict) else None
    if network in HUL_DISCS + ("UNet",) and state is None:
        raise ValueError(f"{network} export needs BatchNorm state (save the "
                         "checkpoint with the trainer, or pass "
                         "{'params': ..., 'state': ...})")
    if network in HUL_DISCS:
        sd = params_io.hul_state_dict_from_jax(params, state, network)
    else:
        sd = params_io.generator_state_dict_from_jax(network, params, state)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, dst)
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", help="torch checkpoint (.pt state_dict or .pth), "
                                "or a JAX-layout .npz for the reverse direction")
    ap.add_argument("dst", nargs="?",
                    help="output path; .npz (default) or .pt for npz->torch")
    ap.add_argument("--network", default="UtNet",
                    help=f"architecture: one of {', '.join(NETWORKS)}, or MobileNetV3 "
                         "(.pt -> .npz only)")
    args = ap.parse_args(argv)
    reverse = args.src.endswith(".npz")
    dst = args.dst or os.path.splitext(args.src)[0] + (".pt" if reverse else ".npz")
    out = (convert_reverse if reverse else convert)(args.src, dst, args.network)
    print(f"converted {args.src} -> {out}")
    return out


if __name__ == "__main__":
    main()
