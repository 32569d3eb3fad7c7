"""Whole-image forward with H split over devices: a fixed footprint a
device at any image size.

Counterpart of ``nind_denoise_tpu/parallel/spatial.py``
``SpatialShardedForward``. JAX shards the image's H axis and lets GSPMD
partition every conv and insert the halo exchanges. Here each device runs
the ordinary forward on a band of rows with a halo that covers the
network's reach, computed and then discarded: no exchange between devices.

* The image is mirror-padded bottom/right to a size the architecture takes
  (``TileEngine.denoise_whole``'s rule), and its rows split into one owned
  band a device, with boundaries on multiples of ``align`` (16 for UtNet's
  four 2x2 pools; 64 for UNet, whose sizes are multiples of 64), so each
  band sees the pooling grid of the whole image.
* A band's input is its owned rows plus ``halo`` rows above and below
  (clipped at the image), extended to a length the architecture takes;
  the forward's outputs in the halo are dropped. UtNet is valid 3x3 convs
  behind a reflect pad of 2, four 2x2 pools and k3 transposed convs: a
  band's own edges disturb its outputs within about 120 rows (the sum of
  the layers' reach at their scales). ``HALO`` is the smallest multiple of
  ``align`` at which the kept rows equal the whole forward bit for bit on
  the CPU at random weights, measured on both networks.
* The image's own top and bottom stay where they are, so the reflect pad
  and zero padding there are the whole forward's.

So the kept rows equal the single-device whole forward within float
rounding (on the CPU bit for bit), and a band's activations are
``(owned + 2 * halo) / height`` of the whole forward's.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..core import tiles as tiles_mod
from . import mesh

HALO = 192


def device_count(height: int, n: int) -> int:
    """JAX's device count for an image of ``height`` rows (its sharded H
    must divide the mesh): the largest divisor of ``height`` that is at
    most ``n``."""
    return max(d for d in range(min(n, height), 0, -1) if height % d == 0)


class SpatialShardedForward:
    """``apply_fns``: the forward on each listed device (one entry a
    device, ``tile_engine.replicate_apply_fn``), NCHW in the compute dtype
    in and out; ``size_check``: the architecture's validator (None: sizes
    that are multiples of 64, as UNet's)."""

    def __init__(self, apply_fns: Sequence[torch.nn.Module], devices: Sequence,
                 size_check=None, compute_dtype: torch.dtype = torch.bfloat16,
                 halo: int = HALO):
        self.devices = [torch.device(d) for d in devices]
        self.ndev = len(self.devices)
        self.apply_fns = list(apply_fns)
        self.size_check = size_check
        self.align = 16 if size_check is not None else 64
        if halo % self.align:
            raise ValueError(f"halo {halo} is not a multiple of {self.align}")
        self.halo = halo
        self.compute_dtype = compute_dtype
        self._streams = mesh.streams_for(self.devices)
        self.last_bands: List[tuple] = []

    def set_params(self, model: torch.nn.Module) -> None:
        """Load ``model``'s weights (and buffers) into every device's copy."""
        state = model.state_dict()
        for fn in {id(f): f for f in self.apply_fns}.values():
            fn.load_state_dict(state)

    def bands(self, height: int) -> List[tuple]:
        """(input start, input end, owned start, owned end) rows a band,
        for a ``height`` the architecture takes."""
        a = self.align
        cuts = sorted({0, height} | {min(height, round(k * height / self.ndev / a) * a)
                                     for k in range(1, self.ndev)})
        out = []
        for o0, o1 in zip(cuts, cuts[1:]):
            s = max(0, o0 - self.halo)
            e = height if o1 == height else min(
                height, s + tiles_mod.next_valid_dim(o1 + self.halo - s, self.size_check))
            out.append((s, e, o0, o1))
        return out

    def prepare(self, img_hwc: np.ndarray):
        """(the image mirror-padded to a size the architecture takes, its
        bands)."""
        h, w = img_hwc.shape[:2]
        th = tiles_mod.next_valid_dim(h, self.size_check)
        tw = tiles_mod.next_valid_dim(w, self.size_check)
        x = np.ascontiguousarray(tiles_mod.pad_to_size(np.asarray(img_hwc, np.float32),
                                                       th, tw))
        return x, self.bands(th)

    def run_band(self, x: np.ndarray, band: tuple, i: int) -> torch.Tensor:
        """Device ``i``'s forward over ``band`` of the prepared image ``x``:
        its owned rows, (rows, W, C) float32 on the host."""
        s, e, o0, o1 = band
        t = torch.from_numpy(x[s:e]).to(self.devices[i], self.compute_dtype)
        y = self.apply_fns[i](t.permute(2, 0, 1)[None])[0, :, o0 - s:o1 - s]
        return y.to(torch.float32).permute(1, 2, 0).cpu()

    def __call__(self, img_hwc: np.ndarray) -> np.ndarray:
        """(H, W, C) float32 -> the forward's (H, W, C) float32 on the host."""
        x, bands = self.prepare(img_hwc)
        self.last_bands = bands
        outs = mesh.run_each(self.devices, lambda i: self.run_band(x, bands[i], i),
                             self._streams, n=len(bands))
        h, w = img_hwc.shape[:2]
        return torch.cat(outs)[:h, :w].numpy()
