"""Tiled inference engine on one device.

Counterpart of ``nind_denoise_tpu/engine/tile_engine.py`` ``TileEngine``:
the storage-dtype image is uploaded once, normalized on the device, padded
with the symmetric (edge-duplicating) mirror through an index gather, cut
into ``cs`` tiles that run through the generator in batches, feathered
and scatter-added in order into an fp32 canvas, then cropped and quantized
on the device. ``out_dtype='device'`` hands back the cropped fp32 canvas as
a tensor for on-device post-ops (the RL stage).

``denoise_many`` coalesces same-shape images into one tile stream (the
serving daemon's continuous batching), and ``AdaptiveEngine`` adapts the
tile size per request over one resolved model.

What the JAX engine does only for the TPU is left out: the transfer
threads and band streaming of engine/transfer.py (the whole image is
uploaded once here), and the shape bucketing to 512, zero-weight dummy
tiles and power-of-two group buckets that keep XLA shapes static (the
canvas is the exact grid and the last batch is short; the output is the
same). fp32 input in bf16 mode is cast to fp16 on the host before the
upload, as the JAX engine does (it halves the upload; <= 5e-4 relative
error, below bf16's own rounding).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core import tiles as tiles_mod
from ..core.tiles import TilePlan, default_cs_ucs
from ..models.utnet import check_cs
from ..utils.device import resolve_device
from . import device_stitch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def _tf32(allow: bool):
    """Scope cuDNN's and cuBLAS's TF32 switches to one engine call."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _reflect_rows(j0: int, n: int, size: int) -> np.ndarray:
    """Symmetric (edge-duplicating) indices [j0, j0+n) into [0, size)."""
    j = np.arange(j0, j0 + n)
    m = np.mod(j, 2 * size)
    return np.where(m < size, m, 2 * size - 1 - m)


def _upload(raw_hwc: np.ndarray, device: torch.device) -> torch.Tensor:
    """Storage pixels to the device, uint16 as int16 of the same bits."""
    raw = np.ascontiguousarray(raw_hwc)
    if raw.dtype == np.uint16:
        raw = raw.view(np.int16)
    return torch.from_numpy(raw).to(device)


def _quantize(out: torch.Tensor, out_dtype: str) -> np.ndarray:
    """Crop-ready fp32 HWC -> host array: integer encodings clip and round
    (half to even), float encodings stay unclipped."""
    if out_dtype == "uint16":
        q = torch.round(torch.clamp(out, 0, 1) * 65535).to(torch.int32)
        return q.cpu().numpy().astype(np.uint16)
    if out_dtype == "uint8":
        return torch.round(torch.clamp(out, 0, 1) * 255).to(torch.uint8).cpu().numpy()
    if out_dtype == "float16":
        return out.to(torch.float16).cpu().numpy()
    if out_dtype == "float32":
        return out.cpu().numpy()
    raise ValueError(f"unknown out_dtype {out_dtype!r}")


class TileEngine:
    """Denoise arbitrarily-sized images through batched tile forwards.

    ``apply_fn(x_nchw) -> y_nchw`` is the generator forward on ``device``
    in the compute dtype (``resolve_apply_fn`` builds it)."""

    def __init__(self, apply_fn: nn.Module, cs: int, ucs: int,
                 ol: int = tiles_mod.DEFAULT_OVERLAP, batch_size: int = 4,
                 compute_dtype: str = "bfloat16", precision: str = "default",
                 max_subpixels: Optional[int] = None, size_check=None,
                 device=None):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        if precision not in ("default", "float32"):
            raise ValueError("precision must be 'default' or 'float32'")
        self.apply_fn = apply_fn
        self.device = resolve_device(device)
        self.cs, self.ucs, self.ol = cs, ucs, ol
        self.pad = (cs - ucs) // 2
        self.batch_size = batch_size
        self.compute_dtype = _DTYPES[compute_dtype]
        self.precision = precision
        # fp32 with precision='float32' is JAX's "highest": no TF32
        self.allow_tf32 = not (compute_dtype == "float32" and precision == "float32")
        self.max_subpixels = max_subpixels
        self.size_check = size_check

    def plan_for(self, height: int, width: int) -> TilePlan:
        return TilePlan(height, width, self.cs, self.ucs, self.ol)

    def _scope(self):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        stack.enter_context(_tf32(self.allow_tf32))
        return stack

    def _check_subpixels(self, n: int, what: str) -> None:
        if self.max_subpixels is not None and n > self.max_subpixels:
            raise RuntimeError(f"TileEngine: {what} of {n} subpixels exceeds "
                               f"max_subpixels={self.max_subpixels}")

    def denoise_raw(self, raw_hwc: np.ndarray, scale: float,
                    out_dtype: str = "float32", progress: bool = False):
        """Denoise from storage-dtype pixels.

        raw_hwc: (H, W, C) uint8/uint16/float; ``scale`` divides to [0, 1].
        ``out_dtype``: 'float32' (unclipped), 'float16', 'uint16', 'uint8'
        (clipped + scaled) as host arrays, or 'device' (the cropped fp32
        HWC canvas as a tensor on the engine's device)."""
        with self._scope():
            return self._denoise_raw_impl(raw_hwc, scale, out_dtype, progress)

    def _padded_hw(self, plan: TilePlan):
        return (plan.ipervl * plan.stride + self.cs,
                plan.iperhl * plan.stride + self.cs)

    def _upload_padded(self, raws, plan: TilePlan) -> torch.Tensor:
        """N same-shape storage images -> their symmetric-padded extents on
        the device, stacked along rows: (N * PH, PW, C)."""
        if raws[0].dtype == np.float32 and self.compute_dtype == torch.bfloat16 \
                and self.precision != "float32":
            raws = [r.astype(np.float16) for r in raws]
        h, w, c = raws[0].shape
        ph, pw = self._padded_hw(plan)
        dev = self.device
        src = _upload(raws[0][None] if len(raws) == 1 else np.stack(raws), dev)
        rows = torch.from_numpy(_reflect_rows(-plan.pad_top, ph, h)).to(dev)
        cols = torch.from_numpy(_reflect_rows(-plan.pad_left, pw, w)).to(dev)
        return src.index_select(1, rows).index_select(2, cols) \
            .reshape(len(raws) * ph, pw, c)

    def _inv_scale(self, scale: float) -> torch.Tensor:
        # 1/scale rounded to fp32, then to the compute dtype (JAX's order)
        return torch.tensor(np.float32(1.0 / scale)).to(self.device, self.compute_dtype)

    def _run_batch(self, padded, canvas, gcoords, scoords, specs, inv_scale) -> None:
        """Forward the tiles gathered at ``gcoords``, then scatter-add them
        in order at ``scoords``."""
        slabs = device_stitch.forward_round(
            self.apply_fn, padded, gcoords, specs, cs=self.cs, ucs=self.ucs,
            pad=self.pad, ol=self.ol, compute_dtype=self.compute_dtype,
            inv_scale=inv_scale)
        device_stitch.scatter_add_slabs(canvas, slabs, scoords, self.ucs)

    def _denoise_raw_impl(self, raw_hwc, scale, out_dtype, progress):
        h, w, c = raw_hwc.shape
        plan = self.plan_for(h, w)
        self._check_subpixels(self.batch_size * self.cs * self.cs * c, "batch")
        padded = self._upload_padded([raw_hwc], plan)
        canvas = torch.zeros((plan.grid_h, plan.grid_w, c), dtype=torch.float32,
                             device=self.device)
        inv_scale = self._inv_scale(scale)
        tiles_per_row = plan.iperhl + 1
        n_rows = plan.ipervl + 1
        for r in range(n_rows):
            for b0 in range(0, tiles_per_row, self.batch_size):
                idxs = range(r * tiles_per_row + b0,
                             r * tiles_per_row + min(b0 + self.batch_size,
                                                     tiles_per_row))
                coords, specs = plan.tile_specs_arrays(idxs)
                self._run_batch(padded, canvas, coords, coords, specs, inv_scale)
            if progress:
                print(f"{r}/{n_rows}")
        out = canvas[:h, :w]
        return out if out_dtype == "device" else _quantize(out, out_dtype)

    # -- cross-image coalescing (continuous batching) -------------------------

    # stacked-band budget of denoise_many, the JAX engine's: beyond it the
    # per-image path is the right tool (coalescing pays for images whose
    # tiles underfill a batch)
    MAX_GROUP_SUBPIXELS = 64 << 20

    def group_fits(self, n: int, height: int, width: int, channels: int = 3) -> bool:
        """Whether ``n`` (height, width) images fit the stacked-band budget
        of ``denoise_many``, so policy layers decide without raising."""
        ph, pw = self._padded_hw(self.plan_for(height, width))
        return n * ph * pw * channels <= self.MAX_GROUP_SUBPIXELS

    def denoise_many(self, raws, scale: float, out_dtype: str = "float32"):
        """Denoise N same-shape images as one tile stream.

        The images stack along the row axis of one padded band and one
        canvas: image i gathers at ``y + i*PH`` and scatters at
        ``y + i*GH``. Tile batches fill across image boundaries; each image
        keeps its own tile order and scatter-add order. On the CPU each
        output equals ``denoise_raw`` of its image bit for bit. On CUDA a
        tile's output can depend on the batch it runs in (cuDNN picks its
        kernels from the whole batch shape; some layers also differ by
        slot), by about one ulp of the compute dtype, so the two agree to
        that.

        ``out_dtype``: host dtypes return one (N, H, W, C) array; 'device'
        returns a list of N cropped fp32 canvas views. Raises ValueError on
        mixed shapes or dtypes, or when the stacked band exceeds
        ``MAX_GROUP_SUBPIXELS``."""
        with self._scope():
            return self._denoise_many_impl(list(raws), scale, out_dtype)

    def _denoise_many_impl(self, raws, scale, out_dtype):
        n = len(raws)
        if n == 0:
            return []
        h, w, c = raws[0].shape
        if any(r.shape != (h, w, c) or r.dtype != raws[0].dtype for r in raws[1:]):
            raise ValueError("denoise_many: images must share shape + dtype")
        plan = self.plan_for(h, w)
        self._check_subpixels(self.batch_size * self.cs * self.cs * c, "batch")
        if not self.group_fits(n, h, w, c):
            ph, pw = self._padded_hw(plan)
            raise ValueError(f"denoise_many: stacked band of {n * ph * pw * c} "
                             f"subpixels exceeds MAX_GROUP_SUBPIXELS")
        padded = self._upload_padded(raws, plan)
        ph, gh = padded.shape[0] // n, plan.grid_h
        canvas = torch.zeros((n * gh, plan.grid_w, c), dtype=torch.float32,
                             device=self.device)
        inv_scale = self._inv_scale(scale)
        # flat stream: image-major, each image's tiles in row-major order
        coords, specs = plan.tile_specs_arrays(range(plan.ntiles))
        img = np.repeat(np.arange(n, dtype=np.int32), plan.ntiles)
        gcoords, scoords = np.tile(coords, (n, 1)), np.tile(coords, (n, 1))
        gcoords[:, 0] += img * ph
        scoords[:, 0] += img * gh
        specs = np.tile(specs, (n, 1))
        for b0 in range(0, len(img), self.batch_size):
            sl = slice(b0, b0 + self.batch_size)
            self._run_batch(padded, canvas, gcoords[sl], scoords[sl], specs[sl],
                            inv_scale)
        if out_dtype == "device":
            return [canvas[i * gh:i * gh + h, :w] for i in range(n)]
        return _quantize(canvas.view(n, gh, plan.grid_w, c)[:, :h, :w], out_dtype)

    def denoise_hwc(self, img_hwc: np.ndarray, progress: bool = False) -> np.ndarray:
        """(H, W, C) float32 in [0,1]-ish -> float32, unclipped."""
        return self.denoise_raw(np.ascontiguousarray(img_hwc), 1.0,
                                out_dtype="float32", progress=progress)

    def denoise_chw(self, img_chw: np.ndarray, progress: bool = False) -> np.ndarray:
        out = self.denoise_hwc(np.ascontiguousarray(img_chw.transpose(1, 2, 0)),
                               progress=progress)
        return out.transpose(2, 0, 1)

    def denoise_tiny(self, raw_hwc: np.ndarray, scale: float,
                     out_dtype: str = "uint16"):
        """Images below the minimum tiling: mirror-pad bottom/right to the
        smallest arch-valid extents, one whole forward, crop back.
        ``out_dtype`` as ``denoise_raw``."""
        with self._scope():
            h, w, c = raw_hwc.shape
            th = tiles_mod.next_valid_dim(h, self.size_check)
            tw = tiles_mod.next_valid_dim(w, self.size_check)
            self._check_subpixels(th * tw * c, "tiny-image forward")
            img = raw_hwc.astype(np.float32)
            if scale != 1.0:
                img = img / np.float32(scale)
            padded = np.ascontiguousarray(tiles_mod.pad_to_size(img, th, tw))
            x = torch.from_numpy(padded).to(self.device, self.compute_dtype)
            y = self.apply_fn(x.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
            y = y[:h, :w].to(torch.float32)
            return y if out_dtype == "device" else _quantize(y, out_dtype)


def resolve_apply_fn(network: str, model: nn.Module,
                     compute_dtype: str = "bfloat16", device=None) -> nn.Module:
    """The generator forward for an engine: a copy of ``model`` on the
    device in the compute dtype, in eval mode, without gradients. Only
    UtNet in bfloat16/float32 is ported."""
    if network != "UtNet":
        raise NotImplementedError(f"resolve_apply_fn: {network} is not ported")
    if compute_dtype not in _DTYPES:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r} is not ported (bfloat16, float32)")
    dev = resolve_device(device)
    return copy.deepcopy(model).to(dev, _DTYPES[compute_dtype]).eval() \
        .requires_grad_(False)


def _resolve_tiles(network: str, cs: Optional[int], ucs: Optional[int]):
    """Per-arch tile defaults + size-formula validation -> (cs, ucs, check)."""
    if network != "UtNet":
        raise NotImplementedError(f"{network} is not ported")
    if cs is None or ucs is None:
        cs, ucs = default_cs_ucs(network)
    check_cs(cs)
    return cs, ucs, check_cs


def make_engine(network: str, model: nn.Module, cs: Optional[int] = None,
                ucs: Optional[int] = None, device=None, **kwargs) -> TileEngine:
    """TileEngine with per-arch tile defaults and size check; ``kwargs``
    go to TileEngine."""
    cs, ucs, check = _resolve_tiles(network, cs, ucs)
    apply_fn = resolve_apply_fn(network, model,
                                kwargs.get("compute_dtype", "bfloat16"), device)
    return TileEngine(apply_fn, cs, ucs, size_check=check, device=device, **kwargs)


class AdaptiveEngine:
    """Per-request denoise recipe of the serving daemon: an engine per
    adapted tile size (``core/tiles.adapt_cs_ucs``), cached, and a tiny-image
    engine for images below the minimum tiling.

    The model is resolved once (one copy on the device in the compute
    dtype) and every cached engine shares it. ``int8`` compute dtypes are
    not ported and raise ``NotImplementedError``."""

    def __init__(self, network: str, model: nn.Module, cs: Optional[int] = None,
                 ucs: Optional[int] = None, batch_size: int = 8,
                 compute_dtype: str = "bfloat16", precision: str = "default",
                 max_subpixels: Optional[int] = None, device=None):
        self.cs, self.ucs, self._check = _resolve_tiles(network, cs, ucs)
        self.device = resolve_device(device)
        self._resolved = resolve_apply_fn(network, model, compute_dtype, self.device)
        self._kw = dict(batch_size=batch_size, compute_dtype=compute_dtype,
                        precision=precision, max_subpixels=max_subpixels,
                        size_check=self._check, device=self.device)
        self._engines: dict = {}

    def _engine_for(self, cs: int, ucs: int) -> TileEngine:
        key = (cs, ucs)
        if key not in self._engines:
            self._engines[key] = TileEngine(self._resolved, cs, ucs, **self._kw)
        return self._engines[key]

    def _tiny_engine(self) -> TileEngine:
        if "tiny" not in self._engines:
            self._engines["tiny"] = TileEngine(self._resolved, self.cs, self.ucs,
                                               **self._kw)
        return self._engines["tiny"]

    def _adapt(self, height: int, width: int):
        """The (cs, ucs) that fits, or None below the minimum tiling."""
        try:
            return tiles_mod.adapt_cs_ucs(height, width, self.cs, self.ucs,
                                          check=self._check)
        except tiles_mod.TilingError:
            return None

    def denoise_raw(self, raw_hwc: np.ndarray, scale: float,
                    out_dtype: str = "float32"):
        """Tiling-adaptive denoise from storage-dtype pixels; ``out_dtype``
        as ``TileEngine.denoise_raw`` (incl. 'device')."""
        tile = self._adapt(*raw_hwc.shape[:2])
        if tile is None:  # below the minimum tiling: pad-to-valid forward
            return self._tiny_engine().denoise_tiny(raw_hwc, scale, out_dtype=out_dtype)
        return self._engine_for(*tile).denoise_raw(raw_hwc, scale, out_dtype=out_dtype)

    def denoise_many(self, raws, scale: float, out_dtype: str = "float32"):
        """Coalesced group denoise (``TileEngine.denoise_many``) when the
        images share shape and dtype, tile validly, underfill one batch
        each (``ntiles < batch_size``) and fit the stacked-band budget;
        otherwise each image runs on its own. Returns per-image results in
        input order: one (N, H, W, C) array for same-shape host dtypes, a
        list for 'device' or mixed shapes."""
        raws = list(raws)
        same = len(raws) >= 2 and all(
            r.shape == raws[0].shape and r.dtype == raws[0].dtype for r in raws[1:])
        tile = self._adapt(*raws[0].shape[:2]) if same else None
        if tile is not None:
            eng = self._engine_for(*tile)
            h, w, c = raws[0].shape
            if eng.plan_for(h, w).ntiles < eng.batch_size \
                    and eng.group_fits(len(raws), h, w, c):
                return eng.denoise_many(raws, scale, out_dtype=out_dtype)
        outs = [self.denoise_raw(r, scale, out_dtype=out_dtype) for r in raws]
        if out_dtype == "device" or any(o.shape != outs[0].shape for o in outs[1:]):
            return outs
        return np.stack(outs)
