"""denoise_image — single-image denoising CLI on one GPU.

Counterpart of ``nind_denoise_tpu/pipeline/denoise_image_cli.py`` ``run()``
on one device: the same flags (``--cs/--ucs/--overlap/-i/-o/-b/--network/
--model_path/--model_parameters/--max_subpixels/--whole_image/--pad/
--models_dpath/--exif_method/--debug/--compute_dtype/--precision/-q``), the
layered YAML config (``-c/--config``, ``-c2/--config2`` over the port's
``configs/common_conf_default.yaml``), network and tile-size autodetection
from the model path, the default output path next to the model, the tiled,
tiny-image and whole-image paths, ``--debug`` tile dumps into ``dbg/``, and
the reference's bit depth by output extension. Plus ``--device`` (CUDA
unless ``--device cpu``).

``--compute_dtype int8|int8_static`` runs the quantized forward (kernel
P1); ``int8_static`` calibrates its static scales on crops of the input
(``ops/qconv.calib_from_image``), as the JAX CLI does, on the whole
input in ``--whole_image`` mode.

``--trace_dir <dir>`` runs the whole command under ``torch.profiler``
(``utils/log.maybe_profile``) and writes a Chrome trace there, as the JAX
CLI writes a ``jax.profiler`` trace.

The engine runs UtNet and UNet, as the JAX one does: the rest of the zoo
(the relics and MobileNetV3 among them) raises ValueError before anything
is loaded or written.

``--devices N`` (``parallel/mesh.make_devices``: ``cuda:0 .. cuda:N-1``,
or N logical CPU devices under ``--device cpu``; absent or without a value,
every visible GPU) runs the tiled path as row bands over the devices
(``parallel/sharded_engine``; ``int8_static`` calibrates on the input
first) and ``--whole_image`` as an H-split forward (``parallel/spatial``)
over the largest divisor of the padded height that is at most N; int8 over
more than one device is refused there, as in JAX. ``--debug`` and images
below the minimum tiling run on one device. With torchrun's variables set
the process joins its group first (``parallel/mesh.init_distributed``).

    python -m nind_denoise_tpu_torch.pipeline.denoise_image_cli \
        -i noisy.tif -o denoised.tiff --network UtNet --model_path ckpt.npz
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import cv2
import numpy as np

from ..core import imgio
from ..core.tiles import TilingError, adapt_cs_ucs, default_cs_ucs
from ..engine.tile_engine import (_IO_DTYPES, _tf32, check_engine_network, make_engine,
                                  make_sharded_denoiser, replicate_apply_fn, size_check)
from ..models import params_io
from ..ops.qconv import calib_from_image
from ..parallel import mesh
from ..utils import conf
from ..utils.log import StageTimers, maybe_profile
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


def build_parser() -> conf.LayeredArgumentParser:
    p = conf.LayeredArgumentParser(
        description=__doc__, default_config_files=[conf.common_config_fpath()])
    p.add_argument("--cs", type=int, help="Tile size")
    p.add_argument("--ucs", type=int, help="Useful tile size")
    p.add_argument("-ol", "--overlap", default=6, type=int,
                   help="Merge crops with this much overlap")
    p.add_argument("-i", "--input", default="in.jpg", type=str)
    p.add_argument("-o", "--output", type=str,
                   help="Output file (default: model_dpath/test/denoised_images/fn.tif)")
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("--debug", action="store_true",
                   help="Dump each tile's input and output as JPEGs into dbg/")
    p.add_argument("--exif_method", default="auto", type=str,
                   help="auto, or noexif to skip EXIF transplant")
    p.add_argument("--g_network", "--network", "--arch", type=str)
    p.add_argument("--model_path",
                   help="generator checkpoint (.npz or torch .pt), or a training "
                        "directory (best, else highest epoch)")
    p.add_argument("--model_parameters", type=str,
                   help='"parameter1=value1,parameter2=value2"')
    p.add_argument("--max_subpixels", type=int)
    p.add_argument("--whole_image", action="store_true",
                   help="One forward over the whole image instead of tiles")
    p.add_argument("--pad", type=int, help="Whole-image mode: side mirror width")
    p.add_argument("--models_dpath", help="Directory that --model_path names are under")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8", "int8_static"],
                   help="int8/int8_static (UtNet only): the quantized forward; "
                        "int8_static calibrates its static scales on the input")
    p.add_argument("--precision", default="default", choices=["default", "float32"],
                   help="float32: no TF32 in float32 convs and matmuls")
    p.add_argument("--trace_dir", help="write a torch.profiler Chrome trace of the run "
                                       "into this directory")
    p.add_argument("-q", "--quality", type=int, default=95,
                   help="JPEG quality for .jpg outputs")
    p.add_argument("--devices", type=int, nargs="?", const=0,
                   help="Shard over this many devices (row bands; --whole_image: "
                        "H bands). Absent or without a value: every visible GPU; "
                        "1 forces the single-device engine")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def check_ported(args) -> None:
    """Raise on a network the engine does not run."""
    check_engine_network(args.g_network)


def load_generator_model(args):
    kwargs = parse_model_parameters(args.model_parameters)
    # activation-from-path convention (denoise_image.py:223-225)
    if not kwargs and args.model_path and "activation" in args.model_path:
        act = args.model_path.split("activation")[-1].split("_")[1]
        kwargs["activation"] = act
        print(f"set model parameters to activation={act} based on model_path")
    return params_io.load_generator(args.model_path, args.g_network,
                                    kwargs.get("activation", "PReLU"),
                                    models_dpath=args.models_dpath)


def save_uint8(img_hwc: np.ndarray, path: str, quality: int = 95) -> None:
    imgio._checked_imwrite(path, cv2.cvtColor(img_hwc, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, int(quality)])


def save_uint16(img_hwc: np.ndarray, path: str) -> None:
    imgio._checked_imwrite(path, cv2.cvtColor(img_hwc, cv2.COLOR_RGB2BGR))


def run(args, timers: Optional[StageTimers] = None) -> str:
    """Denoise ``args.input`` to ``args.output``. ``timers`` (optional)
    collects the decode, load and denoise seconds."""
    if args.model_path is None:
        raise SystemExit("--model_path is required")
    autodetect_network_cs_ucs(args)
    check_ported(args)
    if args.output is None:
        args.output = make_output_fpath(args.input, args.model_path)
    timers = timers or StageTimers()
    with timers.stage("load"):
        model = load_generator_model(args)

    def build_engine(cs, ucs, calib=None):
        return make_engine(args.g_network, model, cs=cs, ucs=ucs, calib=calib,
                           ol=args.overlap, batch_size=args.batch_size,
                           compute_dtype=args.compute_dtype,
                           precision=args.precision,
                           max_subpixels=args.max_subpixels,
                           debug_dir="dbg" if args.debug else None,
                           device=args.device)

    devices = mesh.make_devices(args.devices, args.device)
    if args.debug and len(devices) > 1:
        print("--debug tile dumps are a single-device feature; using 1 device")
        devices = devices[:1]
    start_time = time.time()
    how = ""
    if args.whole_image and len(devices) > 1:
        how = _run_whole_spatial(args, model, devices, timers)
    elif args.whole_image:
        with timers.stage("decode"):
            img = imgio.load_img(args.input)
        with timers.stage("denoise"):
            # int8_static: static scales from crops of the whole input
            calib = (calib_from_image(img.transpose(1, 2, 0))
                     if args.compute_dtype == "int8_static" else None)
            out_chw = build_engine(args.cs, args.ucs, calib).denoise_whole(
                img, pad=args.pad or 0)
            imgio.save_img(out_chw, args.output)
    else:
        with timers.stage("decode"):
            raw, scale = imgio.load_img_raw(args.input)
        with timers.stage("denoise"):
            # int8_static: static scales from crops of this input; only the
            # crops are divided by the storage scale
            calib = (calib_from_image(raw, scale=scale)
                     if args.compute_dtype == "int8_static" else None)
            try:
                cs, ucs = adapt_cs_ucs(raw.shape[0], raw.shape[1], args.cs, args.ucs,
                                       args.overlap, size_check(args.g_network))
                if (cs, ucs) != (args.cs, args.ucs):
                    print(f"Image {raw.shape[1]}x{raw.shape[0]} too small for "
                          f"cs={args.cs}/ucs={args.ucs}; using cs={cs}, ucs={ucs}")
                if len(devices) > 1:
                    engine = make_sharded_denoiser(
                        args.g_network, model, devices, cs=cs, ucs=ucs, ol=args.overlap,
                        batch_size=args.batch_size, compute_dtype=args.compute_dtype,
                        precision=args.precision, max_subpixels=args.max_subpixels,
                        calib=calib)
                    how = f" ({len(devices)}-device row-band sharding)"
                else:
                    engine = build_engine(cs, ucs, calib)
                den = lambda dt: engine.denoise_raw(raw, scale, out_dtype=dt)
            except TilingError:
                # sharding an image below the minimum tiling is pointless
                print(f"Image {raw.shape[1]}x{raw.shape[0]} below the minimum "
                      f"tiling; denoising as one padded forward")
                engine = build_engine(args.cs, args.ucs, calib)
                den = lambda dt: engine.denoise_tiny(raw, scale, out_dtype=dt)
            ext = os.path.splitext(args.output)[1].lower()
            if ext in (".png", ".tif"):
                save_uint16(den("uint16"), args.output)
            elif ext in (".jpg", ".jpeg"):
                save_uint8(den("uint8"), args.output, quality=args.quality)
            else:  # .tiff fp32, unclipped
                out = den("float32" if args.precision == "float32" else "float16")
                imgio.save_img(out.astype(np.float32).transpose(2, 0, 1), args.output)
    print(f"Denoised image written to {args.output}{how}")
    if args.exif_method != "noexif":
        exif_mod.clone_exif(args.input, args.output)
    print("Elapsed time: " + str(time.time() - start_time) + " seconds")
    return args.output


def _run_whole_spatial(args, model, devices, timers: StageTimers) -> str:
    """``--whole_image`` over more than one device: the forward with H split
    into bands (``parallel/spatial.SpatialShardedForward``), over the
    largest divisor of the padded height that is at most the device count
    (1: the plain forward), as the JAX CLI shrinks its mesh."""
    from ..core import tiles as tiles_mod
    from ..parallel.spatial import SpatialShardedForward, device_count

    if args.compute_dtype.startswith("int8"):
        raise SystemExit(
            "--whole_image over >1 device does not support --compute_dtype "
            "int8/int8_static; drop --whole_image (the tiled path supports "
            "it) or use --compute_dtype bfloat16/float32")
    with timers.stage("decode"):
        img = imgio.load_img(args.input)
    with timers.stage("denoise"):
        pad = args.pad or 0
        padded = tiles_mod.whole_image_pad(img, pad) if pad else img.astype(np.float32)
        hp = padded.shape[1]
        nd = device_count(hp, len(devices))
        if nd != len(devices):
            print(f"whole-image H={hp} not divisible by {len(devices)} devices; "
                  f"sharding over {nd}")
        fwd = SpatialShardedForward(
            replicate_apply_fn(args.g_network, model, args.compute_dtype, devices[:nd]),
            devices[:nd], size_check(args.g_network), _IO_DTYPES[args.compute_dtype])
        with _tf32(not (args.compute_dtype == "float32" and args.precision == "float32")):
            y = fwd(padded.transpose(1, 2, 0)).transpose(2, 0, 1)
        imgio.save_img(y[:, pad:-pad, pad:-pad] if pad else y, args.output)
    return f" ({nd}-device spatial sharding, whole image)"


def main(argv=None):
    # torchrun's variables: join the process group before any device work
    if os.environ.get("MASTER_ADDR"):
        mesh.init_distributed()
    args, _ = build_parser().parse_known_args_layered(argv)
    with maybe_profile(args.trace_dir):
        return run(args)


if __name__ == "__main__":
    main()
