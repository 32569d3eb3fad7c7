"""EXIF transplantation with a backend chain.

The reference uses the exiv2 python binding (src/denoise.py:91-124) and
piexif/exiftool fallbacks (denoise_image.py:272-279). None of those may be
present; this module tries, in order: exiv2 -> piexif -> exiftool subprocess
-> PIL (JPEG only), and degrades to a warning instead of failing the
pipeline (EXIF is metadata, not pixels).
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
from typing import Union

PathLike = Union[str, pathlib.Path]


def _try_exiv2(src: str, dst: str) -> bool:
    try:
        import exiv2  # type: ignore
    except ImportError:
        return False
    s = exiv2.ImageFactory.open(src)
    s.readMetadata()
    d = exiv2.ImageFactory.open(dst)
    d.setExifData(s.exifData())
    d.writeMetadata()
    return True


def _try_piexif(src: str, dst: str) -> bool:
    try:
        import piexif  # type: ignore
    except ImportError:
        return False
    if not dst.lower().endswith((".jpg", ".jpeg", ".tif", ".tiff")):
        return False
    try:
        piexif.transplant(src, dst)
        return True
    except Exception:
        return False


def _try_exiftool(src: str, dst: str) -> bool:
    if shutil.which("exiftool") is None:
        return False
    r = subprocess.run(["exiftool", "-overwrite_original", "-TagsFromFile",
                        src, "-exif", dst], capture_output=True)
    return r.returncode == 0


def _try_pil(src: str, dst: str) -> bool:
    if not dst.lower().endswith((".jpg", ".jpeg")):
        return False
    try:
        from PIL import Image

        with Image.open(src) as s:
            exif = s.info.get("exif")
        if not exif:
            return False
        with Image.open(dst) as d:
            d.save(dst, exif=exif, quality="keep" if dst.lower().endswith(("jpg", "jpeg")) else None)
        return True
    except Exception:
        return False


def clone_exif(src_file: PathLike, dst_file: PathLike, verbose: bool = False) -> bool:
    """Copy EXIF from src to dst; returns True on success, warns otherwise."""
    src, dst = str(src_file), str(dst_file)
    for backend in (_try_exiv2, _try_piexif, _try_exiftool, _try_pil):
        try:
            if backend(src, dst):
                if verbose:
                    print(f"Copied EXIF from {src} to {dst} ({backend.__name__})")
                return True
        except Exception as e:
            if verbose:
                print(f"{backend.__name__} failed: {e}")
    print(f"Warning: no EXIF backend could copy metadata {src} -> {dst}")
    return False
