"""Device-side tile gather / feather-mask / scatter-add primitives.

Counterpart of ``nind_denoise_tpu/engine/device_stitch.py``. Masks are built
on the device from six ints per tile, ``[useful_h, useful_w, left, top,
right, bottom]`` (core/tiles.TilePlan.tile_specs_arrays).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def storage_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Convert storage pixels to ``dtype``. uint16 images travel as int16
    tensors of the same bits (few torch ops take uint16), so int16 is read
    back as unsigned here."""
    if t.dtype == torch.int16:
        t = t.to(torch.int32) & 0xFFFF
    return t.to(dtype)


def gather_tiles(padded_hwc: torch.Tensor, coords: np.ndarray, cs: int) -> torch.Tensor:
    """(B, cs, cs, C) tiles at padded coords ``coords`` (B x [y, x])."""
    return torch.stack([padded_hwc[y:y + cs, x:x + cs]
                        for y, x in coords.tolist()])


def feather_mask(specs: torch.Tensor, ucs: int, ol: int) -> torch.Tensor:
    """(B, 6) int -> (B, ucs, ucs, 1) fp32 feather/validity masks: 0 outside
    the useful region, a factor 0.5 on each ``ol``-wide strip that abuts a
    neighbouring tile (factors compound at corners)."""
    h, w, left, top, right, bottom = (specs[:, i, None, None] for i in range(6))
    r = torch.arange(ucs, device=specs.device)[None, :, None]
    c = torch.arange(ucs, device=specs.device)[None, None, :]
    m = ((r < h) & (c < w)).to(torch.float32)
    half = torch.tensor(0.5, dtype=torch.float32, device=specs.device)
    one = torch.tensor(1.0, dtype=torch.float32, device=specs.device)
    m = m * torch.where((left == 1) & (c < ol), half, one)
    m = m * torch.where((top == 1) & (r < ol), half, one)
    m = m * torch.where((right == 1) & (c >= w - ol) & (c < w), half, one)
    m = m * torch.where((bottom == 1) & (r >= h - ol) & (r < h), half, one)
    return m[..., None]


def scatter_add_slabs(canvas: torch.Tensor, slabs: torch.Tensor,
                      coords: np.ndarray, ucs: int) -> None:
    """Accumulate (B, ucs, ucs, C) pre-masked slabs into the canvas at
    per-tile (y, x) origins, in order: slabs overlap in the feather
    strips, so the adds must not run concurrently."""
    for i, (y, x) in enumerate(coords.tolist()):
        canvas[y:y + ucs, x:x + ucs] += slabs[i]


def forward_round(apply_fn: Callable, padded_hwc: torch.Tensor,
                  coords: np.ndarray, specs: np.ndarray, *, cs: int, ucs: int,
                  pad: int, ol: int, compute_dtype: torch.dtype,
                  inv_scale: torch.Tensor) -> torch.Tensor:
    """Gather a tile batch, normalize, forward, crop to the useful slab and
    apply the feather masks -> (B, ucs, ucs, C) fp32 slabs.

    Normalization casts the storage pixels to the compute dtype first and
    then multiplies by ``inv_scale`` in the compute dtype, the JAX engine's
    order (lossy for uint16 in bf16, and kept so for parity)."""
    tiles = storage_to(gather_tiles(padded_hwc, coords, cs), compute_dtype)
    x = (tiles * inv_scale).permute(0, 3, 1, 2)
    y = apply_fn(x).permute(0, 2, 3, 1)
    masks = feather_mask(torch.from_numpy(specs).to(padded_hwc.device), ucs, ol)
    return y[:, pad:pad + ucs, pad:pad + ucs, :].to(torch.float32) * masks
