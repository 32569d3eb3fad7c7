"""Overlap-tile decomposition geometry (host side, pure numpy).

A copy of the part of ``nind_denoise_tpu/core/tiles.py`` that the tiled
engine needs: the grid (``TilePlan``), the six-int feather descriptors
(``tile_specs_arrays``), per-architecture tile defaults, small-image tile
adaptation (``adapt_cs_ucs``) and the pad-to-valid helpers of the
tiny-image path. The host gather/stitch helpers of the original are left
out: the port gathers and stitches on the device (engine/device_stitch.py).

Grid math (reference denoise_image.py:100-104): tiles of ``cs`` on stride
``ucs-ol``; ``iperhl = ceil((W-ucs)/(ucs-ol))`` horizontal steps, analogous
vertical; tile (xi, yi) covers padded coords starting at ``(ucs-ol)*xi``
with receptive pad ``(cs-ucs)/2`` on each side. The source image is padded
once, symmetrically (edge pixel duplicated, numpy's 'symmetric').
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """One tile of the grid."""
    index: int
    xi: int
    yi: int
    abs_x0: int          # top-left of the useful region in image coords
    abs_y0: int
    useful_w: int        # useful region extent (== ucs except at right/bottom edges)
    useful_h: int


# per-architecture tile-size defaults (denoise_image.py:40-42)
CS_UNET, UCS_UNET = 440, 320
CS_UTNET, UCS_UTNET = 504, 480
CS_UNK, UCS_UNK = 512, 448
DEFAULT_OVERLAP = 6  # denoise_image.py:186


def default_cs_ucs(network: Optional[str]) -> Tuple[int, int]:
    if network == "UNet":
        return CS_UNET, UCS_UNET
    if network == "UtNet":
        return CS_UTNET, UCS_UTNET
    return CS_UNK, UCS_UNK


class TilePlan:
    """Static description of an overlap-tile run over one image size.

    ``cs`` crop size fed to the network, ``ucs`` useful crop size
    (stitching stride + ol), ``ol`` feather overlap.
    """

    def __init__(self, height: int, width: int, cs: int, ucs: int, ol: int = DEFAULT_OVERLAP):
        if not (0 < ucs <= cs):
            raise ValueError(f"TilePlan: need 0 < ucs <= cs, got cs={cs} ucs={ucs}")
        if (cs - ucs) % 2:
            raise ValueError(f"TilePlan: cs-ucs must be even, got cs={cs} ucs={ucs}")
        if ol >= ucs:
            raise ValueError(f"TilePlan: overlap {ol} must be < ucs {ucs}")
        if ol > 0 and 2 * ol > ucs:
            # the 0.5+0.5 seam weights sum to 1 only if 2*ol <= ucs
            raise ValueError(
                f"TilePlan: need 2*overlap <= ucs for the seam feathers to "
                f"partition unity, got ol={ol} ucs={ucs}")
        self.H, self.W = int(height), int(width)
        self.cs, self.ucs, self.ol = int(cs), int(ucs), int(ol)
        self.pad = (cs - ucs) // 2
        stride = ucs - ol
        self.stride = stride
        # number of extra steps needed to cover each axis
        self.iperhl = max(0, math.ceil((self.W - ucs) / stride))
        self.ipervl = max(0, math.ceil((self.H - ucs) / stride))
        self.ntiles = (self.iperhl + 1) * (self.ipervl + 1)
        # grid canvas extent (>= image, covers the last tile's useful slab)
        self.grid_w = self.iperhl * stride + ucs
        self.grid_h = self.ipervl * stride + ucs
        # global symmetric padding extents for gather
        self.pad_left = self.pad_top = self.pad
        self.pad_right = self.iperhl * stride + cs - self.pad - self.W
        self.pad_bottom = self.ipervl * stride + cs - self.pad - self.H
        if self.pad_right > self.W or self.pad_bottom > self.H:
            raise ValueError(
                f"TilePlan: image {self.H}x{self.W} too small for cs={cs} ucs={ucs} "
                f"(mirror pad {self.pad_bottom}x{self.pad_right} exceeds image)")

    def spec(self, i: int) -> TileSpec:
        yi = i // (self.iperhl + 1)
        xi = i % (self.iperhl + 1)
        abs_x0 = self.stride * xi
        abs_y0 = self.stride * yi
        return TileSpec(
            index=i, xi=xi, yi=yi, abs_x0=abs_x0, abs_y0=abs_y0,
            useful_w=min(self.ucs, self.W - abs_x0),
            useful_h=min(self.ucs, self.H - abs_y0),
        )

    def tile_specs_arrays(self, indices) -> "tuple[np.ndarray, np.ndarray]":
        """(coords n x 2 [y0, x0], specs n x 6) int32 arrays for a batch:
        ``[useful_h, useful_w, left, top, right, bottom]`` per tile."""
        coords = np.zeros((len(indices), 2), np.int32)
        specs = np.zeros((len(indices), 6), np.int32)
        for j, i in enumerate(indices):
            s = self.spec(i)
            coords[j] = (s.abs_y0, s.abs_x0)
            specs[j] = (s.useful_h, s.useful_w, s.abs_x0 != 0, s.abs_y0 != 0,
                        s.abs_x0 + self.ucs < self.W and self.ol > 0,
                        s.abs_y0 + self.ucs < self.H and self.ol > 0)
        return coords, specs


class TilingError(ValueError):
    """No tiling fits the image (adapt_cs_ucs): callers fall back to the
    tiny-image padded forward (TileEngine.denoise_tiny)."""


def adapt_cs_ucs(height: int, width: int, cs: int, ucs: int,
                 ol: int = DEFAULT_OVERLAP, check=None) -> Tuple[int, int]:
    """(cs, ucs) that actually fit the image: the configured pair when
    valid, else the largest smaller tile with the same receptive pad that
    both fits and passes the arch's size formula (``check``). Raises
    TilingError when nothing fits."""
    pad2 = cs - ucs  # preserve the receptive pad

    def fits(c):
        try:
            TilePlan(height, width, c, c - pad2, ol)
            return True
        except ValueError:
            return False

    def arch_ok(c):
        if check is None:
            return True
        try:
            check(c)
            return True
        except ValueError:
            return False

    if arch_ok(cs) and fits(cs):
        return cs, ucs
    for c in range(cs - 8, pad2 + ol, -8):
        if c - pad2 < max(2 * ol, ol + 1):
            break  # ucs below 2*ol can't feather correctly (TilePlan raises)
        if arch_ok(c) and fits(c):
            return c, c - pad2
    raise TilingError(
        f"adapt_cs_ucs: image {height}x{width} too small for any tiling "
        f"derived from cs={cs}/ucs={ucs}")


def next_valid_dim(n: int, check=None, span: int = 1024) -> int:
    """Smallest spatial extent >= n the architecture accepts (``check`` is
    the arch's size validator, applied per dimension); without one, the
    next multiple of 64."""
    n = max(int(n), 1)
    if check is None:
        return ((n + 63) // 64) * 64
    for d in range(n, n + span):
        try:
            check(d)
            return d
        except ValueError:
            continue
    raise ValueError(f"next_valid_dim: no valid size in [{n}, {n + span})")


def pad_to_size(img_hwc: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Mirror-pad an HWC image on the bottom/right to exactly (th, tw).

    Iterates np.pad(mode='symmetric') so extents may more than double —
    a single symmetric pad is capped at the current size per axis. The
    caller crops the output back with ``[:h, :w]``."""
    out = img_hwc
    while out.shape[0] < th or out.shape[1] < tw:
        ph = min(th - out.shape[0], out.shape[0])
        pw = min(tw - out.shape[1], out.shape[1])
        out = np.pad(out, ((0, ph), (0, pw), (0, 0)), mode="symmetric")
    return out
