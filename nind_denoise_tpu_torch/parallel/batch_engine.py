"""Image-per-device batch inference: the directory scale-out.

Counterpart of ``nind_denoise_tpu/parallel/batch_engine.py``
``DeviceBatchDenoiser``. A batch of same-shape images goes one image a
device; every device runs the whole tile loop of ``TileEngine`` over its
own image into its own canvas, with no collectives and no band merge.
Each device runs on a thread of its own and a stream of its own
(``parallel/mesh.run_each``), so no device waits for another.

``post(i, canvas)`` runs on image i's device right after its denoise (the
RL stage and the quantize, then the download), as the JAX engine keeps
its output sharded for ``rl_deblur_sharded``. On the CPU each output
equals ``TileEngine.denoise_raw`` of its image bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..engine.tile_engine import TileEngine
from ..ops import rl_deblur
from . import mesh


class DeviceBatchDenoiser:
    """Same-shape images, one a listed device; ``engines``: one
    ``TileEngine`` a device (their ``batch_size`` is the tiles per
    dispatch on each device)."""

    def __init__(self, engines: Sequence[TileEngine]):
        self.engines = list(engines)
        self.devices = [e.device for e in self.engines]
        self.ndev = len(self.engines)
        self._streams = mesh.streams_for(self.devices)

    def denoise_batch(self, imgs: Sequence[np.ndarray], scale: float = 1.0,
                      post: Optional[Callable] = None) -> list:
        """Image i of at most ``ndev`` same-shape storage images on device
        i; ``scale`` divides to [0, 1] on the device. Returns, in order,
        ``post(i, canvas)`` of each fp32 HWC canvas on its device, or the
        fp32 canvases on the host without ``post``."""
        imgs = list(imgs)
        if len(imgs) > self.ndev:
            raise ValueError(f"batch {len(imgs)} exceeds the {self.ndev} devices; "
                             f"chunk the batch (see denoise_many)")
        if any(im.shape != imgs[0].shape or im.dtype != imgs[0].dtype for im in imgs):
            raise ValueError("denoise_batch: images must share shape + dtype")

        def one(i):
            out = self.engines[i].denoise_raw(imgs[i], scale, out_dtype="device")
            return post(i, out) if post is not None else out.cpu().numpy()

        return mesh.run_each(self.devices, one, self._streams, n=len(imgs))

    def denoise_many(self, imgs: Sequence[np.ndarray], scale: float = 1.0) -> List[np.ndarray]:
        """Any number of same-shape images: chunks of ``ndev`` through
        ``denoise_batch``, fp32 on the host."""
        imgs = list(imgs)
        return [o for i0 in range(0, len(imgs), self.ndev)
                for o in self.denoise_batch(imgs[i0:i0 + self.ndev], scale)]


def rl_deblur_sharded(imgs: Sequence[torch.Tensor], sigma: float, iterations: int,
                      impl: str = "auto", psf: str = "gaussian") -> List[torch.Tensor]:
    """RL deblur of one HWC image a device (each tensor on its own device):
    every device runs the single-image RL path (``ops/rl_deblur``, so K1 at
    sigma <= 10.67) on its own image, concurrently. Returns the deblurred
    fp32 tensors, each on its input's device."""
    devices = [t.device for t in imgs]
    return mesh.run_each(devices, lambda i: rl_deblur.rl_deblur(
        imgs[i], float(sigma), int(iterations), impl=impl, psf=psf),
        mesh.streams_for(devices))
