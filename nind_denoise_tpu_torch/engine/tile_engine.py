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
tile size per request over one resolved model. ``denoise_whole`` runs the
whole image as one forward (``--whole_image``), and ``debug_dir`` dumps
every tile's input and output as JPEGs (``--debug``).

What the JAX engine does only for the TPU is left out: the transfer
threads and band streaming of engine/transfer.py (the whole image is
uploaded once here), and the shape bucketing to 512, zero-weight dummy
tiles and power-of-two group buckets that keep XLA shapes static (the
canvas is the exact grid and the last batch is short; the output is the
same). fp32 input in bf16 mode is cast to fp16 on the host before the
upload, as the JAX engine does (it halves the upload; <= 5e-4 relative
error, below bf16's own rounding).

The int8 compute dtypes (``int8``, ``int8_static``) run the quantized
forward of ``models/utnet_int8.QuantUtNet`` with bf16 tile I/O;
``recalibrate_int8`` re-derives an ``int8_static`` engine's activation
scales on crops of the image it is about to denoise.
"""

from __future__ import annotations

import contextlib
import copy
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core import tiles as tiles_mod
from ..core.tiles import TilePlan, default_cs_ucs
from ..models.utnet import check_cs
from ..utils.device import resolve_device
from . import device_stitch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the generators the engine runs (the JAX engine's resolve_apply_fn)
ENGINE_NETWORKS = ("UtNet", "UNet")
# the tile I/O dtype of each compute dtype: the int8 modes quantize inside
# the forward, and the normalization, feather masks and canvas stay bf16
_IO_DTYPES = {**_DTYPES, "int8": torch.bfloat16, "int8_static": torch.bfloat16}


_TF32_LOCK = threading.Lock()
# the scopes open now that share one setting: how many, the setting, and
# the switches to put back when the last of them closes
_TF32 = {"users": 0, "allow": None, "saved": None}


def _set_tf32(cudnn: bool, matmul: bool) -> None:
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def _tf32(allow: bool):
    """Scope cuDNN's and cuBLAS's TF32 switches to one engine call.

    The switches are process-wide, and the engine pool runs one engine a
    thread: overlapping scopes of one setting share it, and the switches
    go back when the last of them closes (a scope that restored on its
    own exit would switch them under a sibling still running). A scope of
    another setting nests: it sets its own and puts the outer one back."""
    with _TF32_LOCK:
        share = _TF32["users"] > 0 and _TF32["allow"] == allow
        if share:
            _TF32["users"] += 1
        else:
            outer = dict(_TF32)
            _TF32.update(users=1, allow=allow,
                         saved=(torch.backends.cudnn.allow_tf32,
                                torch.backends.cuda.matmul.allow_tf32))
            _set_tf32(allow, allow)
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32["users"] -= 1
            if _TF32["users"] == 0:
                _set_tf32(*_TF32["saved"])
                if not share:
                    _TF32.update(outer)


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
                 device=None, debug_dir: Optional[str] = None):
        if compute_dtype not in _IO_DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_IO_DTYPES)}")
        if precision not in ("default", "float32"):
            raise ValueError("precision must be 'default' or 'float32'")
        self.apply_fn = apply_fn
        self.device = resolve_device(device)
        self.cs, self.ucs, self.ol = cs, ucs, ol
        self.pad = (cs - ucs) // 2
        self.batch_size = batch_size
        self.compute_dtype = _IO_DTYPES[compute_dtype]
        self.precision = precision
        # fp32 with precision='float32' is JAX's "highest": no TF32
        self.allow_tf32 = not (compute_dtype == "float32" and precision == "float32")
        self.max_subpixels = max_subpixels
        self.size_check = size_check
        self.debug_dir = debug_dir  # dump noisy/denoised tiles per row (slow)

    def recalibrate_int8(self, img_hwc: np.ndarray, scale: float = 1.0) -> bool:
        """``int8_static`` engines: re-derive the static activation scales
        on crops of this image (``ops/qconv.calib_from_image``; only the
        crops are divided by ``scale``). Returns False, doing nothing, for
        any other engine."""
        if not getattr(self.apply_fn, "static", False):
            return False
        from ..ops.qconv import calib_from_image

        self.apply_fn.recalibrate(calib_from_image(np.asarray(img_hwc), scale=scale))
        return True

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

    def _wire_dtype(self, raw: np.ndarray) -> np.ndarray:
        """fp32 input in bf16 mode travels as fp16 (see the module doc)."""
        if raw.dtype == np.float32 and self.compute_dtype == torch.bfloat16 \
                and self.precision != "float32":
            return raw.astype(np.float16)
        return raw

    def _upload_padded(self, raws, plan: TilePlan) -> torch.Tensor:
        """N same-shape storage images -> their symmetric-padded extents on
        the device, stacked along rows: (N * PH, PW, C)."""
        raws = [self._wire_dtype(r) for r in raws]
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
        self._rows_into(padded, canvas, plan, 0, plan.ipervl + 1, self._inv_scale(scale),
                        raw_hwc, scale, progress)
        out = canvas[:h, :w]
        return out if out_dtype == "device" else _quantize(out, out_dtype)

    def _rows_into(self, padded, canvas, plan: TilePlan, r0: int, r1: int, inv_scale,
                   raw_hwc=None, scale: float = 1.0, progress: bool = False) -> None:
        """Tile rows [r0, r1) in batches within each row, in order, into
        ``canvas``; ``padded`` and ``canvas`` start at the first of these
        rows (padded and canvas rows share a tile's y origin)."""
        y0 = r0 * plan.stride
        tiles_per_row = plan.iperhl + 1
        for r in range(r0, r1):
            for b0 in range(0, tiles_per_row, self.batch_size):
                idxs = range(r * tiles_per_row + b0,
                             r * tiles_per_row + min(b0 + self.batch_size,
                                                     tiles_per_row))
                coords, specs = plan.tile_specs_arrays(idxs)
                coords[:, 0] -= y0
                self._run_batch(padded, canvas, coords, coords, specs, inv_scale)
            if self.debug_dir:
                self._dump_debug_tiles(raw_hwc, plan, r, scale)
            if progress:
                print(f"{r}/{r1}")

    def denoise_rows(self, raw_hwc: np.ndarray, scale: float, plan: TilePlan,
                     r0: int, r1: int):
        """Tile rows [r0, r1) of ``plan`` over ``raw_hwc``: one device's row
        band in ``parallel/sharded_engine``. Only the padded input rows
        these tiles read travel (rows ``r0*stride`` to ``(r1-1)*stride +
        cs``, mirrored on the host; the columns are mirrored on the device).
        Returns (the fp32 canvas band on the device, which covers canvas
        rows ``r0*stride`` to ``(r1-1)*stride + ucs``; the bytes uploaded).
        Runs in the caller's scope: no inference mode or TF32 switch of its
        own."""
        h, w, c = raw_hwc.shape
        self._check_subpixels(self.batch_size * self.cs * self.cs * c, "batch")
        y0, band_h = r0 * plan.stride, (r1 - r0 - 1) * plan.stride + self.cs
        band = np.ascontiguousarray(self._wire_dtype(
            raw_hwc[_reflect_rows(y0 - plan.pad_top, band_h, h)]))
        cols = torch.from_numpy(_reflect_rows(-plan.pad_left, self._padded_hw(plan)[1], w))
        padded = _upload(band, self.device).index_select(1, cols.to(self.device))
        canvas = torch.zeros(((r1 - r0 - 1) * plan.stride + self.ucs, plan.grid_w, c),
                             dtype=torch.float32, device=self.device)
        self._rows_into(padded, canvas, plan, r0, r1, self._inv_scale(scale))
        return canvas, band.nbytes

    def _dump_debug_tiles(self, raw_hwc, plan: TilePlan, r: int, scale: float) -> None:
        """--debug (reference denoise_image.py:260-266): each tile of row
        ``r``, its noisy input (the host band / scale) and its output of a
        forward on that tile alone, as 8-bit JPEGs
        ``crop{r}_{xi}_{noisy,denoised}.jpg`` in ``debug_dir``, truncated
        to uint8 as the JAX engine writes them."""
        import cv2

        os.makedirs(self.debug_dir, exist_ok=True)
        h, w = raw_hwc.shape[:2]
        pw = self._padded_hw(plan)[1]
        rows = _reflect_rows(r * plan.stride - plan.pad_top, self.cs, h)
        cols = _reflect_rows(-plan.pad_left, pw, w)
        band = self._wire_dtype(raw_hwc)[rows][:, cols].astype(np.float32) / scale
        for xi in range(plan.iperhl + 1):
            s = plan.spec(r * (plan.iperhl + 1) + xi)
            tile = np.ascontiguousarray(band[:, s.abs_x0:s.abs_x0 + self.cs])
            x = torch.from_numpy(tile).to(self.device, self.compute_dtype)
            out = self.apply_fn(x.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
            for tag, arr in (("noisy", tile), ("denoised", out.float().cpu().numpy())):
                u8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
                path = os.path.join(self.debug_dir, f"crop{r}_{xi}_{tag}.jpg")
                if not cv2.imwrite(path, cv2.cvtColor(u8, cv2.COLOR_RGB2BGR)):
                    raise IOError(f"TileEngine: could not write {path}")

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

    def denoise_whole(self, img_chw: np.ndarray, pad: int = 0) -> np.ndarray:
        """Whole-image mode (reference --whole_image --pad,
        denoise_image.py:196-197): side-mirror padding by ``pad`` with zero
        corners, then bottom/right mirror padding to the next size the
        architecture takes (the reference crashes on other sizes), one
        forward on the engine's device in its compute dtype, crop back.
        (3, H, W) float32 in, (3, H, W) float32 out, unclipped."""
        with self._scope():
            padded = tiles_mod.whole_image_pad(img_chw, pad) if pad \
                else img_chw.astype(np.float32)
            hwc = padded.transpose(1, 2, 0)
            h, w = hwc.shape[:2]
            th = tiles_mod.next_valid_dim(h, self.size_check)
            tw = tiles_mod.next_valid_dim(w, self.size_check)
            if (th, tw) != (h, w):
                hwc = tiles_mod.pad_to_size(hwc, th, tw)
            x = torch.from_numpy(np.ascontiguousarray(hwc)).to(self.device,
                                                               self.compute_dtype)
            y = self.apply_fn(x.permute(2, 0, 1)[None])[0, :, :h, :w]
            y = y.to(torch.float32).cpu().numpy()
            return y[:, pad:-pad, pad:-pad] if pad else y

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
                     compute_dtype: str = "bfloat16", device=None,
                     calib=None) -> nn.Module:
    """The generator forward for an engine: a copy of ``model`` on the
    device in the compute dtype, in eval mode, without gradients; for
    ``int8`` / ``int8_static`` (UtNet only) the quantized forward
    (``QuantUtNet``), ``int8_static`` calibrated on ``calib`` ((N, s, s,
    3) in [0, 1], e.g. ``calib_from_image`` of the input) or, absent one,
    on the synthetic set ``calib_tiles()``. A UNet normalizes with its
    running stats, in fp32 under a bf16 compute dtype (``cast_convs``).
    UtNet and UNet are the engine's networks, as in the JAX package;
    the rest of the zoo raises ValueError ("unsupported generator")."""
    from ..models import get_network

    get_network(network)  # an unknown name raises KeyError
    if network not in ENGINE_NETWORKS:
        raise ValueError(f"resolve_apply_fn: unsupported generator {network}")
    if compute_dtype not in _IO_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    if compute_dtype.startswith("int8") and network != "UtNet":
        raise ValueError(f"compute_dtype={compute_dtype!r} is only supported for UtNet")
    dev = resolve_device(device)
    if compute_dtype.startswith("int8"):
        from ..models.utnet_int8 import QuantUtNet
        from ..ops.qconv import calib_tiles

        q = QuantUtNet(model, static=compute_dtype == "int8_static", device=dev)
        if q.static:
            q.calibrate(calib_tiles() if calib is None else calib)
        return q
    m = copy.deepcopy(model).to(dev)
    m = m.cast_convs(_DTYPES[compute_dtype]) if network == "UNet" \
        else m.to(_DTYPES[compute_dtype])
    return m.eval().requires_grad_(False)


def _resolve_tiles(network: str, cs: Optional[int], ucs: Optional[int]):
    """Per-arch tile defaults + size-formula validation -> (cs, ucs, check);
    UNet takes any size (check None), as in the JAX package."""
    from ..models import get_network

    get_network(network)
    if network not in ENGINE_NETWORKS:
        raise ValueError(f"the tile engine does not run {network}")
    if cs is None or ucs is None:
        cs, ucs = default_cs_ucs(network)
    check = size_check(network)
    if check is not None:
        check(cs)
    return cs, ucs, check


def check_engine_network(network: str, flag: str = "--network") -> None:
    """Raise before anything is loaded or written where the engine does not
    run ``network``: the rest of the zoo, the relics and MobileNetV3 among
    them (ValueError, as the JAX engine's ``resolve_apply_fn`` raises), an
    unknown name (KeyError)."""
    from ..models import get_network

    get_network(network)
    if network not in ENGINE_NETWORKS:
        raise ValueError(f"{flag} {network}: unsupported generator (the engine runs "
                         f"{', '.join(ENGINE_NETWORKS)})")


def size_check(network: str):
    """The architecture's tile-size validator: UtNet's ``check_cs``; None
    (any size) for UNet."""
    return check_cs if network == "UtNet" else None


def make_sharded_denoiser(network: str, model: Optional[nn.Module], devices: Sequence,
                          cs: Optional[int] = None, ucs: Optional[int] = None,
                          ol: int = tiles_mod.DEFAULT_OVERLAP, batch_size: int = 8,
                          compute_dtype: str = "bfloat16", precision: str = "default",
                          max_subpixels: Optional[int] = None, calib=None,
                          apply_fns: Optional[List[nn.Module]] = None):
    """The row-band engine over ``devices`` (``parallel/sharded_engine``),
    the counterpart of the JAX package's ``make_sharded_denoiser``: per-arch
    tile defaults and size check, ``tiles_per_device = max(1, batch_size //
    ndev)``, ``max_subpixels`` and ``precision`` as the single-device
    engine honours them. ``apply_fns`` (one per listed device, from
    ``replicate_apply_fn``) lets callers that build several tile sizes
    share one model copy a device; else ``model`` is resolved here
    (``calib`` as ``resolve_apply_fn``)."""
    from ..parallel.sharded_engine import ShardedTileDenoiser

    devices = [torch.device(d) for d in devices]
    cs, ucs, check = _resolve_tiles(network, cs, ucs)
    if apply_fns is None:
        apply_fns = replicate_apply_fn(network, model, compute_dtype, devices, calib)
    tpd = max(1, batch_size // len(devices))
    return ShardedTileDenoiser([
        TileEngine(fn, cs, ucs, ol=ol, batch_size=tpd, compute_dtype=compute_dtype,
                   precision=precision, max_subpixels=max_subpixels, size_check=check,
                   device=d) for fn, d in zip(apply_fns, devices)])


def replicate_apply_fn(network: str, model: nn.Module, compute_dtype: str,
                       devices: Sequence, calib=None) -> List[nn.Module]:
    """``resolve_apply_fn`` once per distinct device of ``devices``; one
    entry per listed device (a repeated device shares its copy)."""
    from ..parallel.mesh import replicate

    return replicate(lambda d: resolve_apply_fn(network, model, compute_dtype, d,
                                                calib=calib),
                     [torch.device(d) for d in devices])


def make_engine(network: str, model: nn.Module, cs: Optional[int] = None,
                ucs: Optional[int] = None, device=None, calib=None,
                **kwargs) -> TileEngine:
    """TileEngine with per-arch tile defaults and size check; ``calib``
    goes to ``resolve_apply_fn``, ``kwargs`` to TileEngine."""
    cs, ucs, check = _resolve_tiles(network, cs, ucs)
    apply_fn = resolve_apply_fn(network, model,
                                kwargs.get("compute_dtype", "bfloat16"), device,
                                calib=calib)
    return TileEngine(apply_fn, cs, ucs, size_check=check, device=device, **kwargs)


class AdaptiveEngine:
    """Per-request denoise recipe of the serving daemon: an engine per
    adapted tile size (``core/tiles.adapt_cs_ucs``), cached, and a tiny-image
    engine for images below the minimum tiling.

    The model is resolved once (one copy on the device in the compute
    dtype, or one ``QuantUtNet``) and every cached engine shares it. For
    ``int8_static`` each request recalibrates the static scales on its
    own image first, and ``denoise_many`` never coalesces: per-image
    calibration is worth more than batch fill."""

    def __init__(self, network: str, model: nn.Module, cs: Optional[int] = None,
                 ucs: Optional[int] = None, batch_size: int = 8,
                 compute_dtype: str = "bfloat16", precision: str = "default",
                 max_subpixels: Optional[int] = None, device=None):
        self.cs, self.ucs, self._check = _resolve_tiles(network, cs, ucs)
        self.device = resolve_device(device)
        self._resolved = resolve_apply_fn(network, model, compute_dtype, self.device)
        self.compute_dtype = compute_dtype
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
        eng = self._tiny_engine() if tile is None else self._engine_for(*tile)
        eng.recalibrate_int8(raw_hwc, scale)  # int8_static only
        if tile is None:  # below the minimum tiling: pad-to-valid forward
            return eng.denoise_tiny(raw_hwc, scale, out_dtype=out_dtype)
        return eng.denoise_raw(raw_hwc, scale, out_dtype=out_dtype)

    def denoise_many(self, raws, scale: float, out_dtype: str = "float32"):
        """Coalesced group denoise (``TileEngine.denoise_many``) when the
        images share shape and dtype, tile validly, underfill one batch
        each (``ntiles < batch_size``) and fit the stacked-band budget, and
        the mode is not ``int8_static``; otherwise each image runs on its
        own. Returns per-image results in
        input order: one (N, H, W, C) array for same-shape host dtypes, a
        list for 'device' or mixed shapes."""
        raws = list(raws)
        same = len(raws) >= 2 and all(
            r.shape == raws[0].shape and r.dtype == raws[0].dtype for r in raws[1:])
        tile = self._adapt(*raws[0].shape[:2]) \
            if same and self.compute_dtype != "int8_static" else None
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
