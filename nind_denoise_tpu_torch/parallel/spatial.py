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

The trainer's whole-image test (``train/loop.test_generator``) cuts the
same bands, one a data-parallel rank (``rank_bands``, ``run_rank_band``):
each rank forwards its band under ``data_parallel.owned_rows``, so that a
UNet's train-mode BatchNorm takes its statistics from the owned rows of
every band, summed across ranks, and rank 0 gathers the kept rows. The Hul
generators are VALID convs with two stride-3 levels: their bands start on
multiples of 9 (the pooling grid of both levels) and have the length their
validator takes; ``HUL_HALO`` was measured as ``HALO`` was, in float64 at
random weights: the kept rows equal the whole forward to rounding with 117
rows of halo, and not with 108 (``tests/test_torch_dp_test.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core import tiles as tiles_mod
from ..models.utnet import check_cs
from . import data_parallel, mesh

HALO = 192
HUL_HALO = 117


def device_count(height: int, n: int) -> int:
    """JAX's device count for an image of ``height`` rows (its sharded H
    must divide the mesh): the largest divisor of ``height`` that is at
    most ``n``."""
    return max(d for d in range(min(n, height), 0, -1) if height % d == 0)


def bands(height: int, n: int, align: int, halo: int = HALO,
          size_check=None) -> List[tuple]:
    """(input start, input end, owned start, owned end) rows of each of at
    most ``n`` bands of a ``height`` the architecture takes: owned cuts on
    multiples of ``align``, ``halo`` rows above and below (clipped at the
    image), each input extended to a length ``size_check`` takes (None:
    multiples of 64). Fewer than ``n`` bands where cuts coincide."""
    cuts = sorted({0, height} | {min(height, round(k * height / n / align) * align)
                                 for k in range(1, n)})
    out = []
    for o0, o1 in zip(cuts, cuts[1:]):
        s = max(0, o0 - halo)
        e = height if o1 == height else min(
            height, s + tiles_mod.next_valid_dim(o1 + halo - s, size_check))
        out.append((s, e, o0, o1))
    return out


def _multiple_of_64(n: int) -> None:
    if n % 64:
        raise ValueError(f"UNet: {n} is not a multiple of 64")


def _hul_check(n: int) -> None:
    """The Hul generators' sizes: (n - 14) and the stages after it divide
    by 3, and the bottom keeps a row (128 -> 114 -> 38 -> 30 -> 10 -> 2)."""
    m = (n - 14) // 3 - 8
    if n < 14 or (n - 14) % 3 or m <= 0 or m % 3 or m // 3 - 8 <= 0:
        raise ValueError(f"Hul generator: invalid size {n}")


# (align, halo, size check) of each trainable generator's bands
GEOMETRY = {"UNet": (64, HALO, _multiple_of_64), "UtNet": (16, HALO, check_cs),
            "Hulb128Net": (9, HUL_HALO, _hul_check), "Hulbs128Net": (9, HUL_HALO, _hul_check)}


def rank_bands(height: int, width: int, world: int, network: str) -> Optional[List[tuple]]:
    """The trainer's test bands of an image, one a rank, or None where the
    image takes rank 0's whole forward: one process, a height the world
    does not divide (JAX's predicate), a size the network does not take
    (the whole forward raises there, as JAX's does), or fewer bands than
    ranks (an image too short to cut). Read from the shape alone, so every
    rank decides alike."""
    if world <= 1 or height % world:
        return None
    align, halo, check = GEOMETRY[network]
    try:
        check(height)
        check(width)
    except ValueError:
        return None
    out = bands(height, world, align, halo, check)
    return out if len(out) == world else None


def run_rank_band(forward: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                  band: tuple) -> torch.Tensor:
    """``forward`` over ``x``, the input rows ``[s, e)`` of ``band`` of an
    NCHW image, with the band's owned rows marked for a global BatchNorm
    (``data_parallel.owned_rows``): the output's owned rows."""
    s, e, o0, o1 = band
    if x.shape[2] != e - s:
        raise ValueError(f"band {band}: input of {x.shape[2]} rows")
    with data_parallel.owned_rows(o0 - s, o1 - s, e - s):
        y = forward(x)
    return y[:, :, o0 - s:o1 - s]


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
        for a ``height`` the architecture takes (``bands``)."""
        return bands(height, self.ndev, self.align, self.halo, self.size_check)

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
