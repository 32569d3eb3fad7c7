"""External native tools: darktable-cli and gmic discovery and the
XMP-driven runs.

A copy of ``nind_denoise_tpu/pipeline/external.py`` with the same argv
contracts (the reference's src/denoise.py:397-410 stage 1, :448-460
stage 2, :464-475 gmic). RAW development stays on the host in darktable;
RL deblur runs on the GPU by default (ops/rl_deblur.py) and gmic is the
opt-in alternative. ``download_model`` fetches the model table's published
checkpoint (pipeline/denoise_cli.py ``resolve_model``).
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
from typing import Optional, Sequence

DARKTABLE_DEFAULTS = (
    "darktable-cli",
    "/opt/darktable-dev/bin/darktable-cli",
    "/usr/bin/darktable-cli",
    "C:/Program Files/darktable/bin/darktable-cli.exe",
)
GMIC_DEFAULTS = ("gmic", "/usr/bin/gmic")


def find_tool(candidates: Sequence[str], override: Optional[str] = None) -> Optional[str]:
    if override:
        return override if os.path.exists(override) or shutil.which(override) else None
    for cand in candidates:
        found = shutil.which(cand) or (cand if os.path.isfile(cand) else None)
        if found:
            return found
    return None


def find_darktable(override: Optional[str] = None) -> Optional[str]:
    return find_tool(DARKTABLE_DEFAULTS, override)


def find_gmic(override: Optional[str] = None) -> Optional[str]:
    return find_tool(GMIC_DEFAULTS, override)


def run_darktable_stage1(cmd_darktable: str, raw_path: pathlib.Path,
                         s1_xmp: pathlib.Path, out_fpath: pathlib.Path) -> None:
    """RAW + .s1.xmp -> 32-bit uncompressed TIFF (highlight data intact)."""
    subprocess.run(
        [cmd_darktable, str(raw_path), str(s1_xmp), out_fpath.name,
         "--apply-custom-presets", "false",
         "--core",
         "--conf", "plugins/imageio/format/tiff/bpp=32",
         "--conf", "plugins/imageio/format/tiff/compress=0"],
        cwd=out_fpath.parent, check=True)
    if not out_fpath.exists():
        raise ChildProcessError(f"stage-1 export not found: {out_fpath}")


def run_darktable_stage2(cmd_darktable: str, denoised_path: pathlib.Path,
                         s2_xmp: pathlib.Path, out_fpath: pathlib.Path,
                         height: str = "0") -> None:
    """denoised TIFF + .s2.xmp -> 16-bit TIFF (or final output)."""
    width = "100000" if height not in ("0", 0, None) else "0"
    subprocess.run(
        [cmd_darktable, str(denoised_path), str(s2_xmp), out_fpath.name,
         "--icc-intent", "PERCEPTUAL", "--icc-type", "SRGB",
         "--apply-custom-presets", "false",
         "--upscale", "1", "--height", str(height or "0"), "--width", width,
         "--core",
         "--conf", "plugins/imageio/format/tiff/bpp=16",
         "--conf", "plugins/imageio/format/tiff/compress=0",
         "--conf", "plugins/imageio/format/tiff/pixelformat=FALSE"],
        cwd=out_fpath.parent, check=True)


def run_gmic_rl_deblur(cmd_gmic: str, in_fpath: pathlib.Path,
                       out_name: str, sigma: int, iterations: int,
                       quality: str) -> None:
    """Optional byte-compatible gmic path (the default is on-device RL)."""
    subprocess.run(
        [cmd_gmic, str(in_fpath),
         "-deblur_richardsonlucy", f"{sigma},{iterations},1",
         "-/", "256", "cut", "0,255", "round",
         "-o", f"{out_name},{quality}"],
        cwd=in_fpath.parent, check=True)


def download_model(url: str, dest: str) -> None:
    """Fetch the published checkpoint (denoise.py:423-428 equivalent)."""
    import urllib.request

    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    tmp = dest + ".part"
    try:
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, dest)
    except Exception as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"could not download model from {url} ({e}); place the checkpoint "
            f"at {dest} manually") from e
