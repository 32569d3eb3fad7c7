"""Overlap-tiled denoising of a whole image, float32, plain PyTorch.

The reference denoiser's tiling (github.com/trougnouf/nind-denoise,
denoise_image.py): tiles of ``cs`` on a stride of ``ucs - ol`` cover the
image; the image is padded once with the edge-duplicating mirror
(numpy's ``symmetric``) by ``(cs - ucs) / 2`` on the top and left and as
far as the last tile needs on the bottom and right; each tile's output is
cropped to its ``ucs`` centre, cut to the image, and weighted 0.5 on each
``ol``-wide strip it shares with a neighbour (the weights multiply at the
corners), then added into the canvas. Written anew from that
description; it imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch


def grid(height: int, width: int, ucs: int, ol: int) -> Tuple[int, int, int]:
    """(tile rows, tile columns, stride)."""
    stride = ucs - ol
    ny = max(0, math.ceil((height - ucs) / stride)) + 1
    nx = max(0, math.ceil((width - ucs) / stride)) + 1
    return ny, nx, stride


def tiles(height: int, width: int, ucs: int, ol: int) -> List[Tuple[int, int]]:
    """Each tile's (y, x) origin in image coordinates, row by row."""
    ny, nx, stride = grid(height, width, ucs, ol)
    return [(yi * stride, xi * stride) for yi in range(ny) for xi in range(nx)]


def _symmetric(n0: int, count: int, size: int, device) -> torch.Tensor:
    """Indices n0 .. n0 + count - 1 folded into [0, size) by the mirror
    that repeats the edge pixel."""
    j = torch.arange(n0, n0 + count, device=device) % (2 * size)
    return torch.where(j < size, j, 2 * size - 1 - j)


def _weights(n: int, start: int, total: int, ucs: int, ol: int, device) -> torch.Tensor:
    """One axis of a tile's weights: 1 inside the image, 0 past its end,
    0.5 on the strip shared with the previous and with the next tile."""
    c = torch.arange(ucs, device=device)
    w = (c < n).to(torch.float32)
    if ol > 0 and start > 0:
        w = torch.where(c < ol, w * 0.5, w)
    if ol > 0 and start + ucs < total:
        w = torch.where((c >= ucs - ol) & (c < n), w * 0.5, w)
    return w


def denoise(forward: Callable[[torch.Tensor], torch.Tensor], image01: torch.Tensor,
            cs: int, ucs: int, ol: int, batch: int) -> torch.Tensor:
    """(H, W, C) float32 in [0, 1] on the device -> the (H, W, C) float32
    canvas; ``forward`` maps (B, C, cs, cs) to (B, C, cs, cs); tiles run
    ``batch`` at a time."""
    h, w, c = image01.shape
    pad = (cs - ucs) // 2
    dev = image01.device
    origins = tiles(h, w, ucs, ol)
    canvas = torch.zeros((h + ucs, w + ucs, c), dtype=torch.float32, device=dev)
    for b0 in range(0, len(origins), batch):
        block = origins[b0:b0 + batch]
        x = torch.stack([
            image01.index_select(0, _symmetric(y - pad, cs, h, dev))
                   .index_select(1, _symmetric(x0 - pad, cs, w, dev))
            for y, x0 in block]).permute(0, 3, 1, 2)
        y_out = forward(x.contiguous()).permute(0, 2, 3, 1)[:, pad:pad + ucs, pad:pad + ucs]
        for (y, x0), t in zip(block, y_out):
            wy = _weights(min(ucs, h - y), y, h, ucs, ol, dev)
            wx = _weights(min(ucs, w - x0), x0, w, ucs, ol, dev)
            canvas[y:y + ucs, x0:x0 + ucs] += t.float() * (wy[:, None, None] * wx[None, :, None])
    return canvas[:h, :w]
