"""denoise_image — tiled single-image denoising CLI on one GPU.

Counterpart of the single-device tiled path and the tiny-image path of
``nind_denoise_tpu/pipeline/denoise_image_cli.py`` ``run()``: the same flags
for those paths, plus ``--device`` (CUDA unless ``--device cpu``). The
multi-device, whole-image and debug-dump paths are not ported yet.

    python -m nind_denoise_tpu_torch.pipeline.denoise_image_cli \
        -i noisy.tif -o denoised.tiff --network UtNet --model_path ckpt.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import cv2
import numpy as np

from ..core import imgio
from ..core.tiles import TilingError, adapt_cs_ucs, default_cs_ucs
from ..engine.tile_engine import make_engine
from ..models import params_io
from ..models.utnet import check_cs
from . import exif as exif_mod


def autodetect_network_cs_ucs(args) -> None:
    """Arch from model path; per-arch tile defaults (denoise_image.py:59-79).
    When either of --cs/--ucs is unset, both take the arch defaults."""
    if args.g_network is None:
        if "unet" in args.model_path.lower():
            args.g_network = "UNet"
        elif "utnet" in args.model_path.lower():
            args.g_network = "UtNet"
        else:
            sys.exit("Could not determine network architecture from path. "
                     "Please specify --network (typically UNet or UtNet)")
        print(f"Assuming {args.g_network} from path")
    if args.cs is None or args.ucs is None:
        args.cs, args.ucs = default_cs_ucs(args.g_network)
        print(f"cs={args.cs}, ucs={args.ucs}")


def parse_model_parameters(strparameters: Optional[str]) -> dict:
    """'k=v,k=v' model parameter string (nn_common.py:123-124)."""
    if not strparameters:
        return {}
    out = {}
    for kv in strparameters.split(","):
        k, v = kv.split("=")
        out[k] = int(v) if v.isdigit() else v
    return out


def make_output_fpath(input_fpath: str, model_fpath: str) -> str:
    model_dpath = os.path.dirname(os.path.normpath(model_fpath))
    out_dir = os.path.join(model_dpath, "test", "denoised_images")
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{os.path.basename(input_fpath)}_"
                                 f"{os.path.basename(model_fpath)}.tif")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cs", type=int, help="Tile size")
    p.add_argument("--ucs", type=int, help="Useful tile size")
    p.add_argument("-ol", "--overlap", default=6, type=int,
                   help="Merge crops with this much overlap")
    p.add_argument("-i", "--input", default="in.jpg", type=str)
    p.add_argument("-o", "--output", type=str,
                   help="Output file (default: model_dpath/test/denoised_images/fn.tif)")
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("--exif_method", default="auto", type=str,
                   help="auto, or noexif to skip EXIF transplant")
    p.add_argument("--g_network", "--network", "--arch", type=str)
    p.add_argument("--model_path", help="generator checkpoint (.npz or torch .pt)")
    p.add_argument("--model_parameters", type=str,
                   help='"parameter1=value1,parameter2=value2"')
    p.add_argument("--max_subpixels", type=int)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--precision", default="default", choices=["default", "float32"],
                   help="float32: no TF32 in float32 convs and matmuls")
    p.add_argument("-q", "--quality", type=int, default=95,
                   help="JPEG quality for .jpg outputs")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def load_generator_model(args):
    kwargs = parse_model_parameters(args.model_parameters)
    # activation-from-path convention (denoise_image.py:223-225)
    if not kwargs and args.model_path and "activation" in args.model_path:
        act = args.model_path.split("activation")[-1].split("_")[1]
        kwargs["activation"] = act
        print(f"set model parameters to activation={act} based on model_path")
    return params_io.load_generator(args.model_path,
                                    kwargs.get("activation", "PReLU"))


def save_uint8(img_hwc: np.ndarray, path: str, quality: int = 95) -> None:
    imgio._checked_imwrite(path, cv2.cvtColor(img_hwc, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, int(quality)])


def save_uint16(img_hwc: np.ndarray, path: str) -> None:
    imgio._checked_imwrite(path, cv2.cvtColor(img_hwc, cv2.COLOR_RGB2BGR))


def run(args) -> str:
    if args.model_path is None:
        raise SystemExit("--model_path is required")
    autodetect_network_cs_ucs(args)
    if args.output is None:
        args.output = make_output_fpath(args.input, args.model_path)
    model = load_generator_model(args)

    def build_engine(cs, ucs):
        return make_engine(args.g_network, model, cs=cs, ucs=ucs,
                           ol=args.overlap, batch_size=args.batch_size,
                           compute_dtype=args.compute_dtype,
                           precision=args.precision,
                           max_subpixels=args.max_subpixels,
                           device=args.device)

    start_time = time.time()
    raw, scale = imgio.load_img_raw(args.input)
    try:
        cs, ucs = adapt_cs_ucs(raw.shape[0], raw.shape[1], args.cs, args.ucs,
                               args.overlap, check_cs)
        if (cs, ucs) != (args.cs, args.ucs):
            print(f"Image {raw.shape[1]}x{raw.shape[0]} too small for "
                  f"cs={args.cs}/ucs={args.ucs}; using cs={cs}, ucs={ucs}")
        engine = build_engine(cs, ucs)
        den = lambda dt: engine.denoise_raw(raw, scale, out_dtype=dt)
    except TilingError:
        print(f"Image {raw.shape[1]}x{raw.shape[0]} below the minimum "
              f"tiling; denoising as one padded forward")
        engine = build_engine(args.cs, args.ucs)
        den = lambda dt: engine.denoise_tiny(raw, scale, out_dtype=dt)
    ext = os.path.splitext(args.output)[1].lower()
    if ext in (".png", ".tif"):
        save_uint16(den("uint16"), args.output)
    elif ext in (".jpg", ".jpeg"):
        save_uint8(den("uint8"), args.output, quality=args.quality)
    else:  # .tiff fp32, unclipped
        out = den("float32" if args.precision == "float32" else "float16")
        imgio.save_img(out.astype(np.float32).transpose(2, 0, 1), args.output)
    print(f"Denoised image written to {args.output}")
    if args.exif_method != "noexif":
        exif_mod.clone_exif(args.input, args.output)
    print("Elapsed time: " + str(time.time() - start_time) + " seconds")
    return args.output


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
