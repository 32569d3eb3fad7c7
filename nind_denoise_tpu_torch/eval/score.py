"""File-pair quality metrics (MSE / SSIM / MS-SSIM / PSNR) on the device.

Counterpart of ``nind_denoise_tpu/eval/score.py``: ``get_losses`` (mse,
1 - ssim, 1 - ms_ssim, the reference's res dict), ``msssim_files``,
``psnr_files`` and ``gen_score`` (the legacy ``res.txt``), computed with the
port's ``ops/losses.py`` on CUDA unless ``device="cpu"`` is given. Scoring
on CUDA runs with TF32 off, as the JAX package's float32 does, and under
``no_grad``, not ``inference_mode``: the losses cache their MS-SSIM weights
per device, and a tensor made in inference mode would break a later
training step's backward. ms_ssim raises below 162 px a side, as JAX's
does.

``to_device`` and ``losses`` split a file score into its upload and its
device work, so a caller can decode ahead on a thread
(``imgio.load_img``), keep a baseline on the device, or score pixels it
already holds: ``to_device`` of a uint16 array gives the same tensor as
``to_device(imgio.load_img(path))`` of the file that array was written to.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core import imgio
from ..engine.tile_engine import _tf32
from ..ops import losses as L
from ..utils.device import resolve_device


def to_device(img, device=None) -> torch.Tensor:
    """(3, H, W) float32, or (H, W, 3) uint16 pixels as a file holds them,
    -> (1, 3, H, W) float32 on the device."""
    img = np.asarray(img)
    if img.dtype == np.uint16:  # imgio.load_img's arithmetic on the same pixels
        img = img.transpose(2, 0, 1).astype(np.float32) / 65535
    return torch.from_numpy(np.ascontiguousarray(img))[None].to(resolve_device(device))


def _scope(a: torch.Tensor, b: torch.Tensor) -> contextlib.ExitStack:
    """Checks the shapes; no autograd, and on CUDA no TF32 (the switches
    are process-wide, so a CPU score leaves them alone)."""
    if a.shape != b.shape:
        raise ValueError(f"{tuple(a.shape)=} != {tuple(b.shape)=}")
    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    if a.is_cuda:
        stack.enter_context(_tf32(False))
    return stack


def losses(a: torch.Tensor, b: torch.Tensor) -> Dict[str, float]:
    """{'mse', 'ssim', 'msssim'} of two (1, 3, H, W) device tensors; ssim
    and msssim as losses (1 - metric)."""
    with _scope(a, b):
        ssim, msssim = L.ssim_and_ms_ssim(a, b)
        return {"mse": float(L.mse_loss(a, b)[0]), "ssim": float(1.0 - ssim[0]),
                "msssim": float(1.0 - msssim[0])}


def msssim(a: torch.Tensor, b: torch.Tensor) -> float:
    """MS-SSIM metric (not loss) of two (1, 3, H, W) device tensors."""
    with _scope(a, b):
        return float(L.ms_ssim(a, b)[0])


def _pair(img1_fpath: str, img2_fpath: str, device):
    dev = resolve_device(device)
    return (to_device(imgio.load_img(img1_fpath), dev),
            to_device(imgio.load_img(img2_fpath), dev))


def get_losses(img1_fpath: str, img2_fpath: str, device=None) -> Dict[str, float]:
    """{'mse', 'ssim', 'msssim'} — ssim/msssim as LOSSES (1 - metric),
    matching the reference's res dict semantics."""
    return losses(*_pair(img1_fpath, img2_fpath, device))


def msssim_files(img1_fpath: str, img2_fpath: str, device=None) -> float:
    """MS-SSIM metric (not loss) between two image files."""
    return msssim(*_pair(img1_fpath, img2_fpath, device))


def psnr_files(img1_fpath: str, img2_fpath: str, device=None) -> float:
    a, b = _pair(img1_fpath, img2_fpath, device)
    with _scope(a, b):
        return float(L.psnr(a, b)[0])


def gen_score(denoised_dir: str, gt_dir: str, outpath: Optional[str] = None,
              device=None) -> str:
    """Legacy res.txt scorer (loss.py:29-45 parity): per-image SSIM/MSE CSV.
    The baseline is decoded once."""
    from ..train.dataset import get_baseline_fpath

    dev = resolve_device(device)
    baseline = get_baseline_fpath(gt_dir) if os.path.isdir(gt_dir) else gt_dir
    base = to_device(imgio.load_img(baseline), dev)
    lines = []
    for fn in sorted(os.listdir(denoised_dir)):
        fpath = os.path.join(denoised_dir, fn)
        try:
            res = losses(base, to_device(imgio.load_img(fpath), dev))
        except Exception as e:
            print(f"gen_score: skipping {fn} ({e})")
            continue
        lines.append(f"{fn},{1 - res['ssim']},{res['mse']}")
    outpath = outpath or os.path.join(denoised_dir, "res.txt")
    with open(outpath, "w") as f:
        f.write("\n".join(["filename,ssim,mse"] + lines) + "\n")
    return outpath
