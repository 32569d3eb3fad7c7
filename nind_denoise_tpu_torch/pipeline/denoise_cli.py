"""denoise — RAW or stage-1 TIFF -> denoise -> RL deblur -> JPEG, on one GPU.

Counterpart of ``nind_denoise_tpu/pipeline/denoise_cli.py`` (the
reference's docopt pipeline, src/denoise.py:8-35) on one device: the same
options and defaults, file-or-directory input over the same RAW extension
list, the same stage file naming (``<stem>_s1.tif`` 32-bit development,
``_s1_denoised.tiff`` fp32, ``_s2.tif`` 16-bit), the _1.._99 collision
counter and the model table of ``pipeline/operations.yaml`` (``--model``,
default ``nind_generator_650.pt`` at ``models/nind/generator_650.pt`` under
the working directory). Plus ``--device`` (CUDA unless ``--device cpu``)
and ``--precision``.

* RAW input: the XMP sidecar is split (pipeline/xmp.py), darktable-cli
  develops stage 1, the denoiser runs in process (``denoise_image_cli.run``)
  to the ``_s1_denoised.tiff``, darktable applies stage 2 (16-bit,
  ``--height``), and RL runs on the device from the stage-2 file, or in
  gmic with ``--use-gmic``. A RAW without a sidecar is skipped.
* ``--tiff-input`` with a sidecar and darktable found: the same from the
  denoise on. Without them (and without ``--use-gmic`` and ``--debug``)
  everything stays in memory: the denoised canvas stays on the device and
  feeds RL there.
* A directory: its files in sorted order, the engine built once for the
  whole run (``Session``) and the next image decoded on a thread while the
  current one runs.

``-v`` prints the seconds of each stage: decode, load, denoise, rl+encode,
exif, and develop and stage2 where darktable runs.

``--rl-psf gmic_fast`` runs RL with the Deriche IIR (kernel P2), and
``--compute_dtype int8|int8_static`` the quantized forward (kernel P1);
``int8_static`` recalibrates its activation scales on each image, as the
JAX CLI's serial path does. ``--rl-impl auto|xla|pallas`` keeps the JAX
CLI's choices: ``auto`` picks the route by sigma, psf and dt, ``xla`` the
separable body, ``pallas`` the fused RL kernel K1, which refuses dt != 1,
``gmic_fast`` and radii above 32 (``ops/rl_deblur.route_for``).
A model table entry's ``network`` is UtNet or UNet (the engine's
networks).

``--devices N`` (``parallel/mesh.make_devices``; absent or without a value,
every visible GPU; ``--device cpu`` gives N logical CPU devices) runs a
directory's files that take the in-memory path over the devices
(``denoise_dir_batch``): same-shape chunks one image a device
(``parallel/batch_engine``) with RL on each device, a shape with few
images by row bands over all devices (``parallel/sharded_engine``), and the
mixed-shape stragglers one request a device through ``parallel/engine_pool``.
With torchrun's variables (``WORLD_SIZE`` > 1) each process takes every
``WORLD_SIZE``-th file (``parallel/mesh.process_shard``).

A checkpoint missing at the table's path (or at ``--model_path``, which
keeps the entry's ``url``) is fetched from the entry's ``url``
(``external.download_model``) before the run, as the JAX CLI does; a failed
fetch raises ``RuntimeError``. An entry without a ``url`` raises
``FileNotFoundError`` naming the path.

    python -m nind_denoise_tpu_torch.pipeline.denoise_cli img.tif --tiff-input -o out/
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import pathlib
from typing import Optional

import cv2
import numpy as np
import torch

from ..core import imgio
from ..engine.tile_engine import AdaptiveEngine
from ..models import params_io
from ..ops import rl_deblur
from ..utils.log import StageTimers
from . import exif as exif_mod
from . import external, xmp

VALID_EXTENSIONS = [
    "." + e.lower() for e in
    ["3FR", "ARW", "SR2", "SRF", "CR2", "CR3", "CRW", "DNG", "ERF", "FFF",
     "MRW", "NEF", "NRW", "ORF", "PEF", "RAF", "RW2"]
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="denoise", description="Denoise the RAW image <raw_image> and save the result.")
    p.add_argument("raw_image", help="RAW file (or directory of RAWs)")
    p.add_argument("-o", "--output-path", dest="output_path",
                   help="Where to save the result (defaults to input directory)")
    p.add_argument("-e", "--extension", default="jpg", help="Output extension")
    p.add_argument("-d", "--dt", help="Path to darktable-cli")
    p.add_argument("-g", "--gmic", help="Path to gmic")
    p.add_argument("-q", "--quality", default="90", help="JPEG quality")
    p.add_argument("--nightmode", action="store_true",
                   help="Normalize brightness (exposure, toneequal) before denoise")
    p.add_argument("--no_deblur", action="store_true", help="Skip RL-deblur")
    p.add_argument("--debug", action="store_true", help="Keep intermediate files")
    p.add_argument("--tiff-input", dest="tiff_input", action="store_true",
                   help="Input is already a stage-1 TIFF")
    p.add_argument("--sigma", default="1", help="RL-deblur sigma")
    p.add_argument("--iterations", default="10", help="RL-deblur iterations")
    p.add_argument("--rl-impl", default="auto",
                   choices=list(rl_deblur.IMPLS), dest="rl_impl",
                   help="RL route: auto (by sigma, psf and dt), xla (the "
                        "separable body) or pallas (the fused kernel K1; "
                        "dt 1, gaussian, radius <= 32 only)")
    p.add_argument("--rl-psf", default="gaussian",
                   choices=["gaussian", "gmic_fast"], dest="rl_psf",
                   help="RL blur PSF: the exact truncated-FIR gaussian, or "
                        "gmic_fast (the Deriche IIR of gmic's fast blur)")
    p.add_argument("--height", help="Max output height")
    p.add_argument("--copy_num", help="darktable duplicate number (XMP naming)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--version", action="version", version="nind_denoise_tpu_torch")
    p.add_argument("--use-gmic", dest="use_gmic", action="store_true",
                   help="Use the gmic binary for RL-deblur instead of the GPU")
    p.add_argument("--model", default="nind_generator_650.pt",
                   help="Model table key (pipeline/operations.yaml)")
    p.add_argument("--model_path", help="Override generator checkpoint path")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8", "int8_static"],
                   help="int8/int8_static (UtNet only): the quantized forward; "
                        "int8_static calibrates its static scales on each image")
    p.add_argument("--precision", default="default", choices=["default", "float32"],
                   help="float32: no TF32 in float32 convs and matmuls")
    p.add_argument("--cs", type=int, help="Override tile size")
    p.add_argument("--ucs", type=int, help="Override useful tile size")
    p.add_argument("--devices", type=int, nargs="?", const=0,
                   help="Directory mode: dispatch images one-per-device over "
                        "this many devices (parallel/batch_engine). Default: "
                        "all visible devices when >1; 1 forces serial")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def check_good_input(path: pathlib.Path, extensions) -> bool:
    extensions = [extensions] if isinstance(extensions, str) else list(extensions)
    if not path.is_file():
        print(f"This isn't a file: {path} — skipping.")
        return False
    if path.suffix.lower() not in extensions:
        if path.suffix.lower() != ".xmp":
            print(f"Not a (supported) RAW file: {path}, skipping.")
        return False
    return True


def get_stage_filepaths(outpath: pathlib.Path, stage: int):
    """tif = 16-bit, tiff = 32-bit (intentional, denoise.py:259-276)."""
    if stage == 1:
        return (outpath.parent / (outpath.stem + "_s1.tif"),
                outpath.parent / (outpath.stem + "_s1_denoised.tiff"))
    return outpath.parent / (outpath.stem + "_s2.tif")


def resolve_model(args, config) -> dict:
    """The ``models`` table entry of ``--model``, its path overridden by
    ``--model_path`` and made absolute against the working directory. A
    missing checkpoint is downloaded from the entry's ``url``; without one,
    FileNotFoundError names the path."""
    mcfg = dict(config["models"][args.model])
    if args.model_path:
        mcfg["path"] = args.model_path
    if not os.path.isabs(mcfg["path"]):
        mcfg["path"] = os.path.join(os.getcwd(), mcfg["path"])
    if not os.path.exists(mcfg["path"]) and "url" in mcfg:
        print(f"Model checkpoint missing; downloading from {mcfg['url']} ...")
        external.download_model(mcfg["url"], mcfg["path"])
    if not os.path.exists(mcfg["path"]):
        raise FileNotFoundError(
            f"model checkpoint not found: {mcfg['path']} (place it there "
            f"or pass --model_path)")
    return mcfg


class Session:
    """What one run of ``main`` shares across its files: the engines, one
    ``AdaptiveEngine`` per (checkpoint, network, cs, ucs, batch, dtype,
    precision, device) — the checkpoint is loaded once, and each engine
    adapts its tiling per image, so a small image among large ones gets
    its own tile size, never a larger one's, and an ``int8_static``
    engine recalibrates on each image, as the JAX CLI's serial path does
    with its memoized engines — and the decode-ahead thread of directory
    mode. ``close`` shuts the thread down."""

    def __init__(self):
        self.engines: dict = {}
        self.taken: set = set()  # output paths reserved by earlier files
        self._ahead: dict = {}
        self._pool: Optional[cf.ThreadPoolExecutor] = None

    def engine(self, mcfg: dict, args, timers: StageTimers) -> AdaptiveEngine:
        network = mcfg.get("network", "UtNet")
        key = (mcfg["path"], network, args.cs, args.ucs, args.batch_size,
               args.compute_dtype, args.precision, args.device)
        if key not in self.engines:
            with timers.stage("load"):
                model = params_io.load_generator(mcfg["path"], network,
                                                 mcfg.get("activation", "PReLU"))
            with timers.stage("denoise"):
                self.engines[key] = AdaptiveEngine(
                    network, model, cs=args.cs, ucs=args.ucs,
                    batch_size=args.batch_size, compute_dtype=args.compute_dtype,
                    precision=args.precision, device=args.device)
        return self.engines[key]

    def prefetch(self, fpath: pathlib.Path) -> None:
        """Decode ``fpath`` on the thread (cv2 releases the GIL)."""
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(max_workers=1)
        key = str(fpath)
        if key not in self._ahead:
            self._ahead[key] = self._pool.submit(imgio.load_img_raw, key)

    def decode(self, fpath: pathlib.Path):
        fut = self._ahead.pop(str(fpath), None)
        return fut.result() if fut is not None else imgio.load_img_raw(str(fpath))

    def close(self) -> None:
        self._ahead.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


def _run_denoiser(mcfg: dict, in_fpath: pathlib.Path, out_fpath: pathlib.Path,
                  args, timers: StageTimers) -> None:
    """In-process equivalent of the reference's denoise_image.py subprocess."""
    from . import denoise_image_cli

    argv = ["-i", str(in_fpath), "-o", str(out_fpath),
            "--network", mcfg.get("network", "UtNet"),
            "--model_path", mcfg["path"],
            "--compute_dtype", args.compute_dtype,
            "--precision", args.precision,
            "--batch_size", str(args.batch_size)]
    if args.cs:
        argv += ["--cs", str(args.cs)]
    if args.ucs:
        argv += ["--ucs", str(args.ucs)]
    if args.device:
        argv += ["--device", args.device]
    ns = denoise_image_cli.build_parser().parse_known_args_layered(argv)[0]
    if mcfg.get("activation"):
        ns.model_parameters = f"activation={mcfg['activation']}"
    denoise_image_cli.run(ns, timers=timers)


def _denoise_to_tensor(session: Session, mcfg: dict, in_fpath: pathlib.Path,
                       args, timers: StageTimers) -> torch.Tensor:
    """File -> denoised float32 HWC tensor on the engine's device (the fast
    path: the canvas feeds RL without leaving the device). Storage-dtype
    pixels go to the engine, which normalizes on the device."""
    with timers.stage("decode"):
        raw, scale = session.decode(in_fpath)
    engine = session.engine(mcfg, args, timers)
    with timers.stage("denoise"):
        out = engine.denoise_raw(raw, scale, out_dtype="device")
        if args.verbose and out.is_cuda:
            torch.cuda.synchronize()  # charge the queued forwards to this stage
    return out


def _encode_u8(u8_hwc: np.ndarray, out_fpath: pathlib.Path, quality: str) -> None:
    bgr = cv2.cvtColor(np.asarray(u8_hwc), cv2.COLOR_RGB2BGR)
    params = ([cv2.IMWRITE_JPEG_QUALITY, int(quality)]
              if out_fpath.suffix.lower() in (".jpg", ".jpeg") else [])
    imgio._checked_imwrite(str(out_fpath), bgr, params)


def _rl_deblur_ondevice(in_fpath: pathlib.Path, out_fpath: pathlib.Path,
                        sigma: int, iterations: int, quality: str,
                        verbose: bool = False, device=None,
                        psf: str = "gaussian", impl: str = "auto") -> None:
    """RL from the stage-2 file on the device, then the gmic quantize."""
    img = imgio.load_img(str(in_fpath)).transpose(1, 2, 0)  # [0,1] HWC
    _encode_u8(rl_deblur.rl_deblur_to_uint8(img, float(sigma), int(iterations),
                                            device=device, psf=psf, impl=impl),
               out_fpath, quality)
    if verbose:
        print(f"Applied on-device RL-deblur to: {out_fpath}")


def _initial_outpath(args, input_path: pathlib.Path) -> pathlib.Path:
    output_dir = pathlib.Path(args.output_path) if args.output_path else input_path.parent
    ext = "." + args.extension if args.extension[0] != "." else args.extension
    return output_dir if output_dir.suffix != "" \
        else (output_dir / input_path.name).with_suffix(ext)


def _collision_resolve(outpath: pathlib.Path, taken=frozenset()) -> pathlib.Path:
    """_1.._99 collision counter (denoise.py:383-389), appending to the
    already-suffixed stem on repeated collisions as the reference does.
    ``taken``: paths to treat as existing (reserved, not yet written)."""
    i = 1
    while outpath.exists() or outpath in taken:
        outpath = outpath.with_stem(outpath.stem + "_" + str(i))
        i += 1
        if i >= 99:
            raise FileExistsError(f"too many files with the same name near {outpath}")
    return outpath


def denoise_file(args, input_path: pathlib.Path,
                 session: Optional[Session] = None) -> Optional[pathlib.Path]:
    """Denoise one file; returns the output path, or None for a RAW that
    has no XMP sidecar (skipped)."""
    print(input_path)
    if session is None:
        session = Session()
        try:
            return denoise_file(args, input_path, session)
        finally:
            session.close()
    timers = StageTimers()
    outpath = _initial_outpath(args, input_path)

    # darktable duplicate naming (--copy_num, denoise.py:342-350)
    if args.copy_num:
        n = int(args.copy_num)
        copy_number = f"_0{args.copy_num}" if 0 < n < 10 else \
            (f"_{args.copy_num}" if 9 < n < 100 else "")
        input_xmp = input_path.with_stem(input_path.stem + copy_number) \
            .with_suffix(input_path.suffix + ".xmp")
    else:
        input_xmp = input_path.with_suffix(input_path.suffix + ".xmp")
    if args.verbose:
        print(input_xmp)

    sigma = int(args.sigma or 1)
    quality = args.quality or "90"
    iterations = int(args.iterations or 10)

    config = xmp.read_config(nightmode=args.nightmode, verbose=args.verbose)
    cmd_darktable = external.find_darktable(args.dt)
    cmd_gmic = external.find_gmic(args.gmic) if args.use_gmic else None
    if args.use_gmic and cmd_gmic is None:
        raise FileNotFoundError(f"--use-gmic: gmic not found ({args.gmic or 'PATH'})")
    rldeblur = not args.no_deblur

    if cmd_darktable is None and not args.tiff_input:
        print("Error: darktable-cli not found and input is RAW.")
        raise FileNotFoundError("darktable-cli")

    good_file = ((args.tiff_input and check_good_input(input_path, [".tif", ".tiff"]))
                 or check_good_input(input_path, VALID_EXTENSIONS)
                 or check_good_input(input_xmp, ".xmp"))
    if not good_file:
        print("The input raw-image or its XMP were not found, or are not valid.")
        raise FileNotFoundError(input_path)

    have_xmp = input_xmp.is_file()
    if not args.tiff_input and not have_xmp:
        # the reference crashes the whole run here (denoise.py:392 parses
        # the sidecar unconditionally): skip just this file
        print(f"No XMP sidecar for {input_path} ({input_xmp.name} not "
              f"found); skipping (darktable development needs the "
              f"history stack).")
        return None
    mcfg = resolve_model(args, config)

    outpath = _collision_resolve(outpath, session.taken)
    session.taken.add(outpath)
    s1_fpath, s1_denoised_fpath = get_stage_filepaths(outpath, 1)
    s2_fpath = get_stage_filepaths(outpath, 2)
    if not rldeblur:
        s2_fpath = outpath  # no deblur stage -> stage 2 writes the final file

    if not args.tiff_input:
        xmp.split_history(input_xmp, config=config, verbose=args.verbose)
        s1_fpath.unlink(missing_ok=True)
        with timers.stage("develop"):
            external.run_darktable_stage1(cmd_darktable, input_path,
                                          input_xmp.with_suffix(".s1.xmp"),
                                          s1_fpath)
    else:
        s1_fpath = input_path
        if have_xmp:
            xmp.split_history(input_xmp, config=config, verbose=args.verbose)
        else:
            print("Warning: no XMP sidecar; stage-2 darktable ops unavailable.")

    # ---- fast path: no darktable stage 2, RL on the device, no kept
    # intermediates -> the image stays in memory from decode to encode
    stage2_runs = cmd_darktable is not None and have_xmp
    if not stage2_runs and not args.use_gmic and not args.debug:
        denoised01 = _denoise_to_tensor(session, mcfg, s1_fpath, args, timers)
        with timers.stage("rl+encode"):
            _write_host(_to_host(denoised01, args, sigma, iterations,
                                 outpath.suffix.lower() == ".tiff"), outpath, quality)
        with timers.stage("exif"):
            exif_mod.clone_exif(s1_fpath, outpath, verbose=args.verbose)
        for f in [input_xmp.with_suffix(".s1.xmp"), input_xmp.with_suffix(".s2.xmp")]:
            f.unlink(missing_ok=True)
        if args.verbose:
            print(f"stages: {timers.summary()}")
        return outpath

    # ---- denoise (in process) to the stage-1 denoised TIFF ----
    s1_denoised_fpath.unlink(missing_ok=True)
    _run_denoiser(mcfg, s1_fpath, s1_denoised_fpath, args, timers)
    if not s1_denoised_fpath.exists():
        raise RuntimeError(f"denoiser did not produce {s1_denoised_fpath}")
    exif_mod.clone_exif(input_path, s1_denoised_fpath, verbose=args.verbose)

    # ---- stage 2 (darktable ops on the denoised image) ----
    if rldeblur and s2_fpath.is_file():
        s2_fpath.unlink()
    if stage2_runs:
        with timers.stage("stage2"):
            external.run_darktable_stage2(cmd_darktable, s1_denoised_fpath,
                                          input_xmp.with_suffix(".s2.xmp"),
                                          s2_fpath, height=args.height or "0")
    else:
        print("Warning: skipping darktable stage 2 (missing binary or XMP); "
              "writing denoised image as stage-2 output.")
        imgio.save_img(imgio.load_img(str(s1_denoised_fpath)), str(s2_fpath))

    # ---- RL-deblur ----
    if rldeblur:
        with timers.stage("rl+encode"):
            if args.use_gmic:
                restore = None
                if " " in outpath.name:  # gmic can't handle spaces (denoise.py:464-469)
                    restore = outpath.name
                    outpath = outpath.with_name(outpath.name.replace(" ", "_"))
                external.run_gmic_rl_deblur(cmd_gmic, s2_fpath, outpath.name,
                                            sigma, iterations, quality)
                if restore is not None:
                    outpath = outpath.replace(outpath.with_name(restore))
            else:
                _rl_deblur_ondevice(s2_fpath, outpath, sigma, iterations, quality,
                                    verbose=args.verbose, device=args.device,
                                    psf=args.rl_psf, impl=args.rl_impl)

    with timers.stage("exif"):
        exif_mod.clone_exif(s1_fpath, outpath, verbose=args.verbose)

    if not args.debug:
        for f in [s1_fpath, s1_denoised_fpath, s2_fpath,
                  input_xmp.with_suffix(".s1.xmp"), input_xmp.with_suffix(".s2.xmp")]:
            if f not in (input_path, outpath):
                f.unlink(missing_ok=True)
    if args.verbose:
        print(f"stages: {timers.summary()}")
    return outpath


def _batchable(args, f: pathlib.Path, cmd_darktable, cmd_gmic) -> bool:
    """Whether ``f`` takes the in-memory multi-device path: the conditions
    of ``denoise_file``'s fast path (no darktable stage 2, RL on the
    device, no ``--debug``)."""
    if not args.tiff_input or args.debug or (args.use_gmic and cmd_gmic):
        return False
    have_xmp = f.with_suffix(f.suffix + ".xmp").is_file()
    return not (cmd_darktable is not None and have_xmp)


def _to_host(out01: torch.Tensor, args, sigma: int, iterations: int,
             tiff: bool) -> np.ndarray:
    """The fast path's post on the canvas's device: RL + gmic quantize to
    uint8, or without RL the fp32 image for a ``.tiff`` output and the
    plain uint8 quantize otherwise."""
    if not args.no_deblur:
        return rl_deblur.rl_to_u8_device(out01, sigma, iterations, psf=args.rl_psf,
                                         impl=args.rl_impl).cpu().numpy()
    if tiff:
        return out01.cpu().numpy()
    return torch.round(torch.clamp(out01, 0, 1) * 255).to(torch.uint8).cpu().numpy()


def _write_host(arr: np.ndarray, outpath: pathlib.Path, quality: str) -> None:
    """``_to_host``'s image to its file: uint8 encoded, fp32 as a TIFF."""
    if arr.dtype == np.uint8:
        _encode_u8(arr, outpath, quality)
    else:
        imgio.save_img(arr.transpose(2, 0, 1), str(outpath))


def denoise_dir_batch(args, files, devices, session: Session) -> dict:
    """Directory mode over several devices (the JAX CLI's
    ``denoise_dir_batch``); returns {file: output path}.

    Files decode one at a time into per-(shape, dtype, scale) lists; a list
    goes out the moment it holds one image a device, through
    ``DeviceBatchDenoiser`` with RL and the quantize on each image's device
    and one download each. At the end, a shape left with at least half as
    many images as devices keeps the image batcher; the rest (fewer images
    a shape) run one request a device through ``EnginePool`` when they are
    two or more, else by row bands over all devices. Shapes below the
    minimum tiling take the padded forward on the first device.
    ``int8_static`` calibrates on the synthetic set here: one model copy a
    device serves many images (the pool's replicas recalibrate on each)."""
    from ..core.tiles import TilingError, adapt_cs_ucs
    from ..engine.tile_engine import (TileEngine, _resolve_tiles, make_sharded_denoiser,
                                      replicate_apply_fn)
    from ..parallel.batch_engine import DeviceBatchDenoiser
    from ..parallel.engine_pool import EnginePool

    config = xmp.read_config(nightmode=args.nightmode, verbose=args.verbose)
    mcfg = resolve_model(args, config)
    network = mcfg.get("network", "UtNet")
    model = params_io.load_generator(mcfg["path"], network, mcfg.get("activation", "PReLU"))
    ndev = len(devices)
    cs, ucs, check = _resolve_tiles(network, args.cs, args.ucs)
    fns = replicate_apply_fn(network, model, args.compute_dtype, devices)
    sigma, iterations = int(args.sigma or 1), int(args.iterations or 10)
    kw = dict(compute_dtype=args.compute_dtype, precision=args.precision, size_check=check)
    tiff = _initial_outpath(args, files[0]).suffix.lower() == ".tiff"
    engines: dict = {}
    tilings: dict = {}
    written: dict = {}

    def tiling_for(h, w):
        if (h, w) not in tilings:
            tilings[(h, w)] = adapt_cs_ucs(h, w, cs, ucs, check=check)
            if tilings[(h, w)] != (cs, ucs):
                print(f"{w}x{h} images too small for cs={cs}; using cs={tilings[(h, w)][0]}")
        return tilings[(h, w)]

    def cached(key, build):
        if key not in engines:
            engines[key] = build()
        return engines[key]

    def outpath_for(f):
        out = _collision_resolve(_initial_outpath(args, f), session.taken)
        session.taken.add(out)
        return out

    def post(out01):
        return _to_host(out01, args, sigma, iterations, tiff)

    def write(f, outpath, arr):
        _write_host(arr, outpath, args.quality or "90")
        exif_mod.clone_exif(f, outpath, verbose=args.verbose)

    def one_by_one(members, scale, engine, how, run):
        for f, raw in members:
            print(f"\n----------------- {f.name} ({how}) -----------------\n")
            outpath = outpath_for(f)
            write(f, outpath, post(run(engine, raw, scale)))
            written[f] = outpath

    def process_chunk(chunk, scale):
        h, w = chunk[0][1].shape[:2]
        try:
            tile = tiling_for(h, w)
        except TilingError:
            tiny = cached("tiny", lambda: TileEngine(fns[0], cs, ucs, device=devices[0], **kw))
            return one_by_one(chunk, scale, tiny, "tiny, padded forward",
                              lambda e, r, sc: e.denoise_tiny(r, sc, out_dtype="device"))
        if len(chunk) * 2 <= ndev:
            # few images, many devices: row bands use every device per image
            sharded = cached(("band",) + tile, lambda: make_sharded_denoiser(
                network, None, devices, *tile, batch_size=args.batch_size,
                compute_dtype=args.compute_dtype, precision=args.precision,
                apply_fns=fns))
            return one_by_one(chunk, scale, sharded, f"row-band x{ndev}",
                              lambda e, r, sc: e.denoise_raw(r, sc, out_dtype="device"))
        batcher = cached(("batch",) + tile, lambda: DeviceBatchDenoiser([
            TileEngine(fn, *tile, batch_size=max(1, args.batch_size // ndev), device=d, **kw)
            for fn, d in zip(fns, devices)]))
        outs = batcher.denoise_batch([r for _, r in chunk], scale,
                                     post=lambda i, out01: post(out01))
        for j, ((f, _), arr) in enumerate(zip(chunk, outs)):
            print(f"\n----------------- {f.name} (device {j}) -----------------\n")
            outpath = outpath_for(f)
            write(f, outpath, arr)
            written[f] = outpath

    def process_stragglers_pool(groups):
        """Leftovers too few for the image batcher run concurrently, one
        request a device (mixed shapes do not couple; tiny shapes take the
        padded forward inside the replica)."""
        items = [(f, raw, scale, outpath_for(f)) for members, scale in groups
                 for f, raw in members]
        pool = EnginePool(network, model, devices, cs=args.cs, ucs=args.ucs,
                          batch_size=args.batch_size, compute_dtype=args.compute_dtype,
                          precision=args.precision)
        try:
            def one(worker, item):
                f, raw, scale, outpath = item
                write(f, outpath, post(worker.denoise_raw(raw, scale, out_dtype="device")))
                print(f"\n----------------- {f.name} (pool: {worker.device}) "
                      f"-----------------\n")
                return outpath

            for (f, *_), outpath in zip(items, pool.map(items, one)):
                written[f] = outpath
        finally:
            pool.close()

    # streaming decode, grouped by (shape, dtype, scale): host memory holds
    # about one image a device for each distinct shape
    pending: dict = {}
    for f in files:
        raw, scale = imgio.load_img_raw(str(f))
        key = (raw.shape, str(raw.dtype), scale)
        pending.setdefault(key, []).append((f, raw))
        if len(pending[key]) == ndev:
            process_chunk(pending.pop(key), scale)
    small, big = [], []
    for (_, _, scale), members in pending.items():
        (small if len(members) * 2 <= ndev else big).append((members, scale))
    for members, scale in big:
        process_chunk(members, scale)
    if sum(len(m) for m, _ in small) >= 2:
        process_stragglers_pool(small)
    else:
        for members, scale in small:
            process_chunk(members, scale)
    return written


def main(argv=None):
    """Denoise a file (returns its output path, or None if skipped) or a
    directory (returns the list of this process's files' outputs, in sorted
    file order)."""
    from ..parallel import mesh

    # torchrun's variables: join the process group before any device work
    if os.environ.get("MASTER_ADDR"):
        mesh.init_distributed()
    args = build_parser().parse_args(argv)
    input_path = pathlib.Path(args.raw_image)
    session = Session()
    try:
        if not input_path.is_dir():
            return denoise_file(args, input_path, session)
        # the reference's directory loop over the RAW extension list
        # (denoise.py:491-500); with --tiff-input, the TIFFs
        exts = [".tif", ".tiff"] if args.tiff_input else VALID_EXTENSIONS
        files = [f for f in sorted(input_path.iterdir()) if f.suffix.lower() in exts]
        if mesh.process_count() > 1:
            # images are independent: each process owns a strided shard
            nfiles = len(files)
            files = mesh.process_shard(files)
            print(f"{mesh.process_count()} processes: process {mesh.process_index()} "
                  f"takes {len(files)}/{nfiles} files")
        devices = mesh.make_devices(args.devices, args.device)
        done: dict = {}
        if len(devices) > 1 and files:
            cmd_darktable = external.find_darktable(args.dt)
            cmd_gmic = external.find_gmic(args.gmic) if args.use_gmic else None
            batch = [f for f in files if _batchable(args, f, cmd_darktable, cmd_gmic)]
            if batch:
                done = denoise_dir_batch(args, batch, devices, session)
        rest = [f for f in files if f not in done]
        for i, f in enumerate(rest):
            if args.tiff_input and i + 1 < len(rest):
                session.prefetch(rest[i + 1])  # overlap the decode with compute
            print(f"\n----------------------- {f.name} -------------------------\n")
            done[f] = denoise_file(args, f, session)
        return [done[f] for f in files]
    finally:
        session.close()


if __name__ == "__main__":
    main()
