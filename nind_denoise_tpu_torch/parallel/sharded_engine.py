"""Row-band tile parallelism: one image, its tile rows split over devices.

Counterpart of ``nind_denoise_tpu/parallel/sharded_engine.py``
``ShardedTileDenoiser``:

* **Row-band ownership.** The tile rows split into one contiguous band a
  device (sizes differ by at most one row; a device past the last row
  idles). Each device receives only the padded input rows its tiles read
  (``(rows-1)*stride + cs`` of them) and accumulates into its own canvas
  band of ``(rows-1)*stride + ucs`` rows, never the full canvas.
* **Zero collectives.** Tiles are disjoint and their halos are read from
  the device's own input band. Adjacent canvas bands overlap only in the
  ``ol``-row feather strip; the host adds the bands in order after one
  download a band.
* **No host sync between devices.** Each device runs its band on a thread
  of its own, on a stream of its own (``parallel/mesh.run_each``), with
  ``TileEngine``'s per-row tile batches of ``tiles_per_device``.

Bytes moved per image (``last_bytes_uploaded`` / ``last_bytes_downloaded``,
the JAX package's formula over devices that hold rows): uploads are the
padded rows plus (n-1) band overlaps of ``cs - stride`` rows, at the raw
width in the storage dtype (the columns are mirrored on the device);
downloads are the fp32 canvas plus (n-1) overlaps of ``ol`` rows.

On the CPU the result equals ``TileEngine.denoise_raw`` bit for bit where
at most two tiles meet (every pixel in bf16, whose slabs sum exactly in
fp32); where four tiles meet at a band seam, the fp32 sums are added in
another order, within an ulp of fp32.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..engine.tile_engine import (AdaptiveEngine, TileEngine, _quantize, _tf32,
                                  make_sharded_denoiser, replicate_apply_fn)
from . import mesh


def row_bands(n_rows: int, ndev: int) -> List[tuple]:
    """Contiguous [r0, r1) tile-row ranges, one a device; the first
    ``n_rows % ndev`` take one row more, and a device past the last row
    gets an empty range."""
    base, extra = divmod(n_rows, ndev)
    out, r = [], 0
    for d in range(ndev):
        n = base + (d < extra)
        out.append((r, r + n))
        r += n
    return out


class ShardedTileDenoiser:
    """Denoise one image with its tile rows split over ``engines``, one
    ``TileEngine`` a listed device (``tile_engine.make_sharded_denoiser``
    builds them; each engine's ``batch_size`` is the tiles per device)."""

    def __init__(self, engines: List[TileEngine]):
        self.engines = list(engines)
        self.devices = [e.device for e in self.engines]
        self.ndev = len(self.engines)
        e0 = self.engines[0]
        self.cs, self.ucs, self.ol = e0.cs, e0.ucs, e0.ol
        self.tiles_per_device = e0.batch_size
        self._streams = mesh.streams_for(self.devices)
        self.last_bytes_uploaded = 0
        self.last_bytes_downloaded = 0

    def recalibrate_int8(self, img_hwc: np.ndarray, scale: float = 1.0) -> bool:
        """``int8_static``: re-derive each device's static scales on crops
        of this image (``TileEngine.recalibrate_int8``)."""
        done = {}
        for e in self.engines:
            if id(e.apply_fn) not in done:
                done[id(e.apply_fn)] = e.recalibrate_int8(img_hwc, scale)
        return any(done.values())

    def denoise_raw(self, raw_hwc: np.ndarray, scale: float, out_dtype: str = "float32"):
        """As ``TileEngine.denoise_raw``; host arrays, or 'device' for the
        cropped fp32 canvas on the first device."""
        h, w, c = raw_hwc.shape
        e0 = self.engines[0]
        plan = e0.plan_for(h, w)
        bands = row_bands(plan.ipervl + 1, self.ndev)

        def band(i):
            r0, r1 = bands[i]
            if r1 == r0:
                return None
            canvas, up = self.engines[i].denoise_rows(raw_hwc, scale, plan, r0, r1)
            return canvas.cpu(), up

        with _tf32(e0.allow_tf32):  # process-wide: switched once for every thread
            outs = mesh.run_each(self.devices, band, self._streams)
        canvas = torch.zeros((plan.grid_h, plan.grid_w, c), dtype=torch.float32)
        self.last_bytes_uploaded = self.last_bytes_downloaded = 0
        for (r0, _), got in zip(bands, outs):
            if got is None:
                continue
            part, up = got
            y0 = r0 * plan.stride
            # the feather strips were pre-halved by the masks: adding merges them
            canvas[y0:y0 + part.shape[0]] += part
            self.last_bytes_uploaded += up
            self.last_bytes_downloaded += part.numel() * part.element_size()
        out = canvas[:h, :w]
        if out_dtype == "device":
            return out.to(self.devices[0])
        return _quantize(out, out_dtype)


class AdaptiveSharded:
    """``AdaptiveEngine``'s per-request recipe over row bands: a
    ``ShardedTileDenoiser`` for each adapted tile size (built on first use,
    every one sharing one model copy a device), and the first device's
    ``AdaptiveEngine`` for images below the minimum tiling. ``int8_static``
    recalibrates on each image, as ``AdaptiveEngine`` does."""

    def __init__(self, network: str, model, devices, cs: Optional[int] = None,
                 ucs: Optional[int] = None, batch_size: int = 8,
                 compute_dtype: str = "bfloat16", precision: str = "default",
                 max_subpixels: Optional[int] = None):
        self.devices = [torch.device(d) for d in devices]
        self.tiny = AdaptiveEngine(network, model, cs=cs, ucs=ucs, batch_size=batch_size,
                                   compute_dtype=compute_dtype, precision=precision,
                                   max_subpixels=max_subpixels, device=self.devices[0])
        self.cs, self.ucs = self.tiny.cs, self.tiny.ucs
        self._kw = dict(batch_size=batch_size, compute_dtype=compute_dtype,
                        precision=precision, max_subpixels=max_subpixels,
                        apply_fns=replicate_apply_fn(network, model, compute_dtype,
                                                     self.devices))
        self._network = network
        self._sharded: dict = {}

    def sharded_for(self, cs: int, ucs: int) -> ShardedTileDenoiser:
        if (cs, ucs) not in self._sharded:
            self._sharded[(cs, ucs)] = make_sharded_denoiser(
                self._network, None, self.devices, cs=cs, ucs=ucs, **self._kw)
        return self._sharded[(cs, ucs)]

    def denoise_raw(self, raw_hwc: np.ndarray, scale: float, out_dtype: str = "float32"):
        """As ``AdaptiveEngine.denoise_raw`` ('device': on the first device)."""
        tile = self.tiny._adapt(*raw_hwc.shape[:2])
        if tile is None:
            return self.tiny.denoise_raw(raw_hwc, scale, out_dtype=out_dtype)
        sharded = self.sharded_for(*tile)
        sharded.recalibrate_int8(raw_hwc, scale)  # int8_static only
        return sharded.denoise_raw(raw_hwc, scale, out_dtype=out_dtype)
