"""denoise — TIFF -> tiled UtNet denoise -> RL deblur -> JPEG, on one GPU.

Counterpart of the ``--tiff-input`` in-memory path of
``nind_denoise_tpu/pipeline/denoise_cli.py`` ``denoise_file``: the stage-1
TIFF is decoded in its storage dtype, denoised by the tiled engine with the
result kept on the device, deblurred there by Richardson-Lucy with the gmic
``*65535/256, cut, round`` quantize, encoded by OpenCV, and the EXIF of the
input is copied onto the output. Output naming follows the reference,
including the _1.._99 collision counter.

Not ported yet: the darktable stages (RAW input), ``--use-gmic``,
directory batches and nightmode.

    python -m nind_denoise_tpu_torch.pipeline.denoise_cli img.tif \
        --tiff-input --model_path generator.npz -o out/
"""

from __future__ import annotations

import argparse
import pathlib
import time
from typing import Optional

import cv2
import numpy as np
import torch

from ..core import imgio
from ..core.tiles import TilingError, adapt_cs_ucs, default_cs_ucs
from ..engine.tile_engine import make_engine
from ..models import params_io
from ..models.utnet import check_cs
from ..ops import rl_deblur
from . import exif as exif_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="denoise", description="Denoise the TIFF <raw_image> and save the result.")
    p.add_argument("raw_image", help="stage-1 TIFF (with --tiff-input)")
    p.add_argument("-o", "--output-path", dest="output_path",
                   help="Where to save the result (defaults to input directory)")
    p.add_argument("-e", "--extension", default="jpg", help="Output extension")
    p.add_argument("-q", "--quality", default="90", help="JPEG quality")
    p.add_argument("--no_deblur", action="store_true", help="Skip RL-deblur")
    p.add_argument("--tiff-input", dest="tiff_input", action="store_true",
                   help="Input is already a stage-1 TIFF")
    p.add_argument("--sigma", default="1", help="RL-deblur sigma")
    p.add_argument("--iterations", default="10", help="RL-deblur iterations")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--model_path", required=True, help="generator checkpoint")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--precision", default="default", choices=["default", "float32"],
                   help="float32: no TF32 in float32 convs and matmuls")
    p.add_argument("--cs", type=int, help="Override tile size")
    p.add_argument("--ucs", type=int, help="Override useful tile size")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def _initial_outpath(args, input_path: pathlib.Path) -> pathlib.Path:
    output_dir = pathlib.Path(args.output_path) if args.output_path else input_path.parent
    ext = "." + args.extension if args.extension[0] != "." else args.extension
    return output_dir if output_dir.suffix != "" \
        else (output_dir / input_path.name).with_suffix(ext)


def _collision_resolve(outpath: pathlib.Path) -> pathlib.Path:
    """_1.._99 collision counter (denoise.py:383-389), appending to the
    already-suffixed stem on repeated collisions as the reference does."""
    i = 1
    while outpath.exists():
        outpath = outpath.with_stem(outpath.stem + "_" + str(i))
        i += 1
        if i >= 99:
            raise FileExistsError(f"too many files with the same name near {outpath}")
    return outpath


def _encode_u8(u8_hwc: np.ndarray, out_fpath: pathlib.Path, quality: str) -> None:
    bgr = cv2.cvtColor(np.asarray(u8_hwc), cv2.COLOR_RGB2BGR)
    params = ([cv2.IMWRITE_JPEG_QUALITY, int(quality)]
              if out_fpath.suffix.lower() in (".jpg", ".jpeg") else [])
    imgio._checked_imwrite(str(out_fpath), bgr, params)


def _denoise_to_tensor(args, in_fpath: pathlib.Path, stages: dict) -> torch.Tensor:
    """File -> denoised float32 HWC tensor on the engine's device. Adds
    the host seconds of the decode and the checkpoint load to ``stages``."""
    t0 = time.time()
    raw, scale = imgio.load_img_raw(str(in_fpath))
    t1 = time.time()
    model = params_io.load_generator(args.model_path)
    stages["decode"], stages["load"] = t1 - t0, time.time() - t1
    cs, ucs = args.cs, args.ucs
    if cs is None or ucs is None:
        cs, ucs = default_cs_ucs("UtNet")
    kw = dict(batch_size=args.batch_size, compute_dtype=args.compute_dtype,
              precision=args.precision, device=args.device)
    try:
        cs, ucs = adapt_cs_ucs(raw.shape[0], raw.shape[1], cs, ucs, check=check_cs)
    except TilingError:
        # below the minimum tiling: pad-to-valid single forward
        engine = make_engine("UtNet", model, **kw)
        return engine.denoise_tiny(raw, scale, out_dtype="device")
    engine = make_engine("UtNet", model, cs=cs, ucs=ucs, **kw)
    return engine.denoise_raw(raw, scale, out_dtype="device")


def denoise_file(args, input_path: pathlib.Path) -> Optional[pathlib.Path]:
    print(input_path)
    if not args.tiff_input:
        raise NotImplementedError(
            "RAW input needs the darktable stages, which are not ported; "
            "pass a stage-1 TIFF with --tiff-input")
    if not input_path.is_file() or input_path.suffix.lower() not in (".tif", ".tiff"):
        raise FileNotFoundError(f"not a TIFF file: {input_path}")
    outpath = _collision_resolve(_initial_outpath(args, input_path))
    sigma = int(args.sigma or 1)
    iterations = int(args.iterations or 10)
    quality = args.quality or "90"

    stages: dict = {}
    t0 = time.time()
    denoised01 = _denoise_to_tensor(args, input_path, stages)
    if args.verbose and denoised01.is_cuda:
        torch.cuda.synchronize()  # charge the queued forwards to this stage
    t1 = time.time()
    stages["denoise"] = t1 - t0 - stages["decode"] - stages["load"]
    if not args.no_deblur:
        u8 = rl_deblur.rl_to_u8_device(denoised01, sigma, iterations)
        _encode_u8(u8.cpu().numpy(), outpath, quality)
    elif outpath.suffix.lower() == ".tiff":
        imgio.save_img(denoised01.cpu().numpy().transpose(2, 0, 1), str(outpath))
    else:
        u8 = torch.round(torch.clamp(denoised01, 0, 1) * 255).to(torch.uint8)
        _encode_u8(u8.cpu().numpy(), outpath, quality)
    t2 = time.time()
    stages["rl+encode"] = t2 - t1
    exif_mod.clone_exif(input_path, outpath, verbose=args.verbose)
    stages["exif"] = time.time() - t2
    if args.verbose:
        print("stages: " + ", ".join(f"{k}: {v:.3f}s" for k, v in stages.items()))
    return outpath


def main(argv=None) -> Optional[pathlib.Path]:
    args = build_parser().parse_args(argv)
    input_path = pathlib.Path(args.raw_image)
    if input_path.is_dir():
        raise NotImplementedError("directory input is not ported yet")
    return denoise_file(args, input_path)


if __name__ == "__main__":
    main()
