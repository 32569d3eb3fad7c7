"""denoise_dir — batch test/eval harness over a directory or test reserve.

Counterpart of ``nind_denoise_tpu/eval/denoise_dir.py`` (the reference's
denoise_dir.py:49-132) on one GPU: resolves the sets to denoise from
``--noisy_dir`` or the test-reserve yaml, denoises every non-baseline image,
scores MSE/SSIM/MS-SSIM against the lowest-ISO ground truth, averages per
set and overall, and records results into ``trainres.json`` (best-effort),
``testres.json`` and the legacy ``res.txt``.

One checkpoint load and one ``AdaptiveEngine`` (per-image tile adaptation,
tiny-image fallback) serve the whole run, in the engine's default bf16;
``--whole_image`` runs ``TileEngine.denoise_whole``. The next image is
decoded on a thread while the card denoises the current one; with
``--skip_existing`` an image whose output exists is neither decoded nor
denoised. Each set's baseline is decoded once and kept on the device, and
a freshly denoised uint16 image is scored from the pixels just written
(the same float32 tensor a decode of the file gives).

Beyond the JAX flags: ``--device`` (CUDA unless ``cpu``). Networks other
than UtNet and UNet (the relics and MobileNetV3 among them) raise
ValueError, as the JAX engine does.

``--devices N`` (``parallel/mesh.make_devices``; absent: every visible GPU)
denoises each image by row bands over the devices
(``parallel/sharded_engine.AdaptiveSharded``, a band engine per adapted
tile size); ``--whole_image`` stays on the first device, as in JAX. Under
torchrun's variables (``WORLD_SIZE`` > 1, ``MASTER_ADDR``/``MASTER_PORT``,
``RANK``) each process denoises and scores every ``process_count()``-th
image of each set; the per-set (sum, count) of the scores is all-gathered
over ``gloo``, which is also the barrier before the first process alone
writes the JSON files and runs the legacy scorer.

    python -m nind_denoise_tpu_torch.eval.denoise_dir --model_path <run dir> \
        --noisy_dir <scenes> --result_dir <results>
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import sys
from typing import List

from ..core import imgio
from ..engine.tile_engine import AdaptiveEngine, check_engine_network, make_engine
from ..models import params_io
from ..parallel import mesh
from ..parallel.sharded_engine import AdaptiveSharded
from ..pipeline import denoise_image_cli
from ..train.dataset import get_baseline_fpath
from ..utils import conf, json_saver, utilities
from . import score


def build_parser():
    p = conf.LayeredArgumentParser(
        description=__doc__, default_config_files=[conf.common_config_fpath()])
    p.add_argument("--noisy_dir", type=str,
                   help="directory of test sets (or a directory of images)")
    p.add_argument("--g_network", "--network", type=str)
    p.add_argument("--model_path", "--model_fpath")
    p.add_argument("--model_parameters", default="", type=str)
    p.add_argument("--result_dir", default="../../results/NIND/test", type=str)
    p.add_argument("--no_scoring", action="store_true")
    p.add_argument("--cs", type=int)
    p.add_argument("--ucs", type=int)
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--whole_image", action="store_true")
    p.add_argument("--pad", type=int)
    p.add_argument("--max_subpixels", type=int)
    p.add_argument("--test_reserve", nargs="*")
    p.add_argument("--orig_data")
    p.add_argument("--models_dpath")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--devices", type=int, nargs="?", const=0,
                   help="denoise each image by row bands over this many devices "
                        "(absent or without a value: every visible GPU)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


LOSS_KEYS = ("mse", "ssim", "msssim")


def check_ported(args) -> None:
    """Raise on a network the engine does not run."""
    check_engine_network(args.g_network)


def _out_fpath(save_dir: str, fn: str) -> str:
    """uint16 output cannot be a JPEG (cv2: 8-bit only): a jpeg-ish
    extension (.jpg/.JPG/.jpeg) gets ``.tif`` appended."""
    p = os.path.join(save_dir, fn)
    ext = os.path.splitext(p)[1]
    return p + ".tif" if ext.lower() in (".jpg", ".jpeg") else p


def main(argv=None):
    from ..train.loop import get_test_reserve_list

    # torchrun's variables: join the process group before any device work
    if os.environ.get("MASTER_ADDR"):
        mesh.init_distributed()
    args = build_parser().parse_known_args_layered(argv)[0]
    if args.model_path is None:
        raise SystemExit("--model_path is required")
    denoise_image_cli.autodetect_network_cs_ucs(args)
    check_ported(args)
    devices = mesh.make_devices(args.devices, args.device)
    device = devices[0]
    model_path = params_io.complete_path(args.model_path,
                                         models_dpath=args.models_dpath,
                                         keyword="generator")

    if args.noisy_dir is not None:
        sets = sorted(os.listdir(args.noisy_dir))
        if sets and os.path.isfile(os.path.join(args.noisy_dir, sets[0])):
            sets = ["."]
        save_dir = os.path.join(args.result_dir,
                                model_path.split(os.sep)[-2]
                                if os.sep in model_path else "model")
    else:
        if not args.test_reserve:
            sys.exit("error: provide --noisy_dir or --test_reserve "
                     "(nothing to evaluate)")
        if not args.orig_data or not os.path.isdir(args.orig_data):
            # the layered config supplies a relative default; if it does not
            # resolve here, fail with the flag name
            sys.exit(f"error: --test_reserve reads scenes from --orig_data, "
                     f"which is {args.orig_data!r} (not a directory)")
        sets = get_test_reserve_list(args.test_reserve)
        args.noisy_dir = args.orig_data
        reserve_tag = (utilities.get_leaf(args.test_reserve[0])
                       if len(args.test_reserve) == 1
                       and os.path.isfile(args.test_reserve[0])
                       else str(args.test_reserve))
        save_dir = os.path.join(utilities.get_root(model_path), "test",
                                utilities.get_leaf(model_path), reserve_tag)
    os.makedirs(save_dir, exist_ok=True)

    # one checkpoint load and one engine for the whole run
    args.model_path = model_path
    model = denoise_image_cli.load_generator_model(args)
    if args.whole_image:
        engine = make_engine(args.g_network, model, cs=args.cs, ucs=args.ucs,
                             batch_size=args.batch_size,
                             max_subpixels=args.max_subpixels, device=device)
    elif len(devices) > 1:
        engine = AdaptiveSharded(args.g_network, model, devices, cs=args.cs, ucs=args.ucs,
                                 batch_size=args.batch_size,
                                 max_subpixels=args.max_subpixels)
    else:
        engine = AdaptiveEngine(args.g_network, model, cs=args.cs, ucs=args.ucs,
                                batch_size=args.batch_size,
                                max_subpixels=args.max_subpixels, device=device)

    pcount, pidx = mesh.process_count(), mesh.process_index()
    if pcount > 1:
        print(f"{pcount} processes: process {pidx} takes every {pcount}th image "
              f"of each set")
    losses_per_set: List[dict] = []
    # decode-ahead: the next image decodes on a worker thread while the
    # current one runs on the device
    with cf.ThreadPoolExecutor(max_workers=1) as decode_pool:
        for aset in sets:
            set_dir = os.path.join(args.noisy_dir, aset)
            baseline = get_baseline_fpath(set_dir)
            base_t = None  # decoded on the set's first score
            losses_per_img = []
            work = mesh.process_shard(
                fn for fn in sorted(os.listdir(set_dir))
                if os.path.isfile(os.path.join(set_dir, fn))
                and os.path.join(set_dir, fn) != baseline)
            # what actually needs denoising: skipped images are not decoded
            todo = [not (args.skip_existing and os.path.isfile(_out_fpath(save_dir, fn)))
                    for fn in work]
            pending = {}
            for idx, fn in enumerate(work):
                in_fpath = os.path.join(set_dir, fn)
                out_fpath = _out_fpath(save_dir, fn)
                nxt = next((j for j in range(idx + 1, len(work)) if todo[j]), None)
                if nxt is not None and nxt not in pending:
                    pending[nxt] = decode_pool.submit(
                        imgio.load_img_raw, os.path.join(set_dir, work[nxt]))
                written = None  # the uint16 pixels this run wrote
                if todo[idx]:
                    fut = pending.pop(idx, None)
                    raw, scale = fut.result() if fut is not None \
                        else imgio.load_img_raw(in_fpath)
                    if args.whole_image:
                        img = raw.astype("float32").transpose(2, 0, 1) / scale
                        imgio.save_img(engine.denoise_whole(img, pad=args.pad or 128),
                                       out_fpath)
                    else:
                        written = engine.denoise_raw(raw, scale, out_dtype="uint16")
                        denoise_image_cli.save_uint16(written, out_fpath)
                if args.no_scoring:
                    # the user opted out of metrics: no baseline comparison
                    # (e.g. a flat directory with no real ground truth)
                    continue
                if base_t is None:
                    base_t = score.to_device(imgio.load_img(baseline), device)
                cur = score.losses(base_t, score.to_device(
                    written if written is not None else imgio.load_img(out_fpath), device))
                print(f"in: {in_fpath}, out: {out_fpath}, clean: {baseline}")
                print(cur)
                losses_per_img.append(cur)
            if pcount > 1:
                # every process gathers every set, empty shard or not: the
                # collective is also the barrier for this set's output files
                tot = mesh.process_allgather(
                    [sum(d[k] for d in losses_per_img) for k in LOSS_KEYS]
                    + [len(losses_per_img)]).sum(axis=0)
                if tot[-1] > 0:
                    losses_per_set.append({k: float(tot[i] / tot[-1])
                                           for i, k in enumerate(LOSS_KEYS)})
            elif losses_per_img:
                losses_per_set.append(utilities.avg_listofdicts(losses_per_img))
    overall = utilities.avg_listofdicts(losses_per_set)
    print(overall)
    if pidx != 0:
        return overall  # the first process writes the records (same values)

    # record into trainres.json (best-effort) + testres.json (denoise_dir.py:105-129)
    epoch = None
    try:
        epoch = int(utilities.get_leaf(model_path).split("_")[1].split(".")[0])
        js = json_saver.JSONSaver(os.path.join(utilities.get_root(model_path),
                                               "trainres.json"), step_type="epoch")
        js.add_res(step=epoch, res=overall, key_prefix="test_")
    except (ValueError, IndexError) as e:
        print(f"Cannot determine epoch from model_path {model_path} ({e})")
    try:
        js = json_saver.JSONSaver(os.path.join(utilities.get_root(model_path),
                                               "testres.json"), step_type="epoch")
        js.add_res(step=epoch if epoch is not None else 0, res=overall,
                   key_prefix="test_")
    except Exception as e:
        print(f"testres saver failed ({e}); dumping raw")
        utilities.dict_to_json(overall, os.path.join(
            utilities.get_root(model_path), "testres.json"))
    if not args.no_scoring and sets and sets != ["."]:
        try:
            score.gen_score(save_dir, os.path.join(args.noisy_dir, sets[0]),
                            device=device)
        except Exception as e:
            print(f"legacy scorer skipped: {e}")
    return overall


if __name__ == "__main__":
    main()
