"""Host-side image decode/encode (pure numpy + OpenCV).

A copy of ``load_img``, ``load_img_raw``, ``save_img``, ``CropMethod``,
``pad_img_pair``, ``crop_img_pair`` and ``crop_to_multiple`` from
``nind_denoise_tpu/core/imgio.py``:

* ``load_img``: RGB float32 CHW; uint8 / 255, uint16 / 65535, float32
  passthrough (values above 1.0 from highlight reconstruction survive).
* ``load_img_raw``: HWC in the storage dtype plus the scale to [0, 1]; the
  engine normalizes on the device.
* ``save_img``: bit depth by extension — .jpg 8-bit, .png/.tif 16-bit,
  .tiff float32 with no clipping (written by OpenCV, not imageio).
* ``pad_img_pair`` / ``crop_img_pair``: the training dataset's centred
  zero pad and identical (random or centre) crop of a clean/noisy pair;
  ``crop_to_multiple`` trims whole test images to a multiple of 64.
"""

from __future__ import annotations

import os
import random
from enum import Enum, auto
from typing import Tuple

import cv2
import numpy as np


class CropMethod(Enum):
    RAND = auto()
    CENTER = auto()


def load_img(fpath: str) -> np.ndarray:
    """Image file -> float32 RGB array of shape (3, H, W)."""
    if not os.path.isfile(fpath):
        raise FileNotFoundError(fpath)
    bgr = cv2.imread(fpath, flags=cv2.IMREAD_COLOR + cv2.IMREAD_ANYDEPTH)
    if bgr is None:
        raise ValueError(f"imgio.load_img: could not decode {fpath}")
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).transpose(2, 0, 1)
    if rgb.dtype == np.float32:
        return rgb
    if rgb.dtype == np.uint8:
        return rgb.astype(np.float32) / 255
    if rgb.dtype == np.uint16:
        return rgb.astype(np.float32) / 65535
    raise TypeError(f"imgio.load_img: {fpath} has unsupported dtype {rgb.dtype}")


def load_img_raw(fpath: str) -> Tuple[np.ndarray, float]:
    """Image file -> (HWC array in its STORAGE dtype, scale-to-[0,1])."""
    if not os.path.isfile(fpath):
        raise FileNotFoundError(fpath)
    bgr = cv2.imread(fpath, flags=cv2.IMREAD_COLOR + cv2.IMREAD_ANYDEPTH)
    if bgr is None:
        raise ValueError(f"imgio.load_img_raw: could not decode {fpath}")
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    scale = {np.dtype(np.uint8): 255.0, np.dtype(np.uint16): 65535.0,
             np.dtype(np.float32): 1.0}.get(rgb.dtype)
    if scale is None:
        raise TypeError(
            f"imgio.load_img_raw: {fpath} has unsupported dtype {rgb.dtype}")
    return rgb, scale


def _checked_imwrite(path: str, bgr: np.ndarray, params=()) -> None:
    """cv2.imwrite returns False on failure instead of raising."""
    if not cv2.imwrite(path, bgr, list(params)):
        raise IOError(f"imgio: cv2 could not write {path} "
                      f"(missing directory, permissions, or disk full?)")


def save_img(img_chw: np.ndarray, path: str) -> None:
    """float32 (3,H,W) -> file. Bit depth by extension:

    .jpg/.jpeg : 8-bit  (clip 0-1)
    .png/.tif  : 16-bit (clip 0-1)
    .tiff      : float32, NO clipping (keeps >1.0 highlights)
    """
    img_chw = np.asarray(img_chw)
    if img_chw.dtype != np.float32:
        img_chw = img_chw.astype(np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        arr = (np.clip(img_chw, 0, 1) * 255).round().astype(np.uint8).transpose(1, 2, 0)
        _checked_imwrite(path, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
    elif ext in (".png", ".tif"):
        arr = (np.clip(img_chw, 0, 1) * 65535).round().astype(np.uint16).transpose(1, 2, 0)
        _checked_imwrite(path, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
    elif ext == ".tiff":
        # OpenCV writes float32 TIFFs itself; imageio (the JAX package's
        # writer) need not be installed where the port runs. Both read back
        # bit for bit through load_img.
        _checked_imwrite(path, cv2.cvtColor(np.ascontiguousarray(
            img_chw.transpose(1, 2, 0)), cv2.COLOR_RGB2BGR))
    else:
        raise NotImplementedError(f"imgio.save_img: extension of {path}")


def pad_img_pair(img1: np.ndarray, img2: np.ndarray, cs: int):
    """Zero-pad both images of a pair up to at least (cs, cs), centered."""
    xpad0 = max(0, (cs - img1.shape[2]) // 2)
    xpad1 = max(0, cs - img1.shape[2] - xpad0)
    ypad0 = max(0, (cs - img1.shape[1]) // 2)
    ypad1 = max(0, cs - img1.shape[1] - ypad0)
    padding = ((0, 0), (ypad0, ypad1), (xpad0, xpad1))
    return np.pad(img1, padding), np.pad(img2, padding)


def crop_img_pair(img1: np.ndarray, img2: np.ndarray, cs: int,
                  crop_method: CropMethod = CropMethod.RAND,
                  rng: "random.Random" = random):
    """Identical crop of an image pair to (cs, cs); RAND or CENTER."""
    if crop_method is CropMethod.RAND:
        x0 = rng.randint(0, img1.shape[2] - cs)
        y0 = rng.randint(0, img1.shape[1] - cs)
    else:
        x0 = (img1.shape[2] - cs) // 2
        y0 = (img1.shape[1] - cs) // 2
    return img1[:, y0:y0 + cs, x0:x0 + cs], img2[:, y0:y0 + cs, x0:x0 + cs]


def crop_to_multiple(img: np.ndarray, multiple: int = 64) -> np.ndarray:
    """Trim trailing rows/cols so H and W are multiples of ``multiple``."""
    h = img.shape[-2] - img.shape[-2] % multiple
    w = img.shape[-1] - img.shape[-1] % multiple
    return img[..., :h, :w]
