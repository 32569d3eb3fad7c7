"""Host-side image decode/encode (pure numpy + OpenCV).

A copy of ``load_img``, ``load_img_raw`` and ``save_img`` from
``nind_denoise_tpu/core/imgio.py``:

* ``load_img``: RGB float32 CHW; uint8 / 255, uint16 / 65535, float32
  passthrough (values above 1.0 from highlight reconstruction survive).
* ``load_img_raw``: HWC in the storage dtype plus the scale to [0, 1]; the
  engine normalizes on the device.
* ``save_img``: bit depth by extension — .jpg 8-bit, .png/.tif 16-bit,
  .tiff float32 with no clipping.
"""

from __future__ import annotations

import os
from typing import Tuple

import cv2
import numpy as np


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
        import imageio.v2 as imageio

        imageio.imwrite(path, img_chw.transpose(1, 2, 0))
    else:
        raise NotImplementedError(f"imgio.save_img: extension of {path}")
