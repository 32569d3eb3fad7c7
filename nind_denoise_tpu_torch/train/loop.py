"""nn_train on one GPU — train a UtNet denoising generator, alone or as a
cGAN against one or two Hul discriminators.

The counterpart of ``nind_denoise_tpu/train/loop.py`` (the reference's
nn_train.py:118-448): layered YAML config
(common + train defaults + --config/--config2), loss weights {SSIM,
MSSSIM, L1, MSE} normalized to 1, experiment dir named by timestamp +
argv, Printer tee to train.log, JSONSaver trainres.json with best
tracking, per-epoch checkpointing (``--checkpoint_interval``, new-best
epochs always) with retention of only the best epochs, validation every
``validation_interval``, optional whole-image test, the patience-window LR
decay, ``--msssim_warmup_epochs``, ``--clean_data_ratio``,
``--log_interval`` (metrics summed on the device, read once an epoch),
``time_limit`` and ``min_lr`` stops, a checkpoint on SIGTERM/SIGINT, and
the debug options {short_run, check_dataset, output_val_images,
output_test_images, keep_all_output_images}.

``--weight_D1``/``--weight_D2`` > 0 add the conditional discriminators
(``train/gan.py``; ``--d_network``/``--d2_network`` one of the four Hul
discriminators), scheduled against the generator by the reference's
stochastic rule from ``random.Random(seed)``, with ``--freeze_generator``
and ``--discriminator_advantage``. ``--device_cache N`` holds N crop
pairs on the device and augments them there (``train/device_cache.py``).

Checkpoints are the JAX trainer's ``.npz`` files (params, optimizer
leaves, epoch; discriminators with their BN state and plateau scheduler;
``models/params_io``): either trainer resumes from the other's with
``--g_model_path`` / ``--d_model_path`` / ``--d2_model_path``. Not ported
yet, and refused: networks other than UtNet and the Hul discriminators
(ROADMAP item 7) and multi-host runs (item 9).

    python -m nind_denoise_tpu_torch.train.loop \\
        --config nind_denoise_tpu_torch/configs/train_conf_utnet_std.yaml \\
        --train_data <cropped dir> --validation_set_yaml <pairs.yaml> \\
        --models_dpath <dir> [--weight_D1 0.2 --d_lr 1e-4] [--device_cache N] \\
        [--compute_dtype bfloat16] [--device cpu]
"""

from __future__ import annotations

import collections
import datetime
import os
import random
import shutil
import signal
import statistics
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch
import yaml

from ..engine.tile_engine import _tf32
from ..models import HUL_DISCS, params_io
from ..models.utnet import UtNet
from ..utils import conf, json_saver
from ..utils.device import resolve_device
from ..utils.log import Printer
from . import dataset as ds_mod
from . import steps
from .gan import DiscriminatorWrapper

DEBUG_OPTIONS = ("short_run", "check_dataset", "output_val_images",
                 "output_test_images", "keep_all_output_images")


def build_parser():
    cfg_dir = conf.default_configs_dir()
    p = conf.LayeredArgumentParser(
        description=__doc__,
        default_config_files=[os.path.join(cfg_dir, "common_conf_default.yaml"),
                              os.path.join(cfg_dir, "train_conf_defaults.yaml")])
    p.add_argument("--batch_size", type=int)
    p.add_argument("--time_limit", type=int)
    p.add_argument("--g_activation", type=str, default="PReLU")
    p.add_argument("--g_funit", type=int, default=32)
    p.add_argument("--g_model_path")
    p.add_argument("--models_dpath")
    p.add_argument("--beta1", type=float)
    p.add_argument("--g_lr", type=float)
    p.add_argument("--weight_SSIM", type=float)
    p.add_argument("--weight_MSSSIM", type=float)
    p.add_argument("--weight_L1", type=float)
    p.add_argument("--weight_MSE", type=float)
    p.add_argument("--test_reserve", nargs="*")
    p.add_argument("--train_data", nargs="*")
    p.add_argument("--cs", "--crop_size", type=int)
    p.add_argument("--min_crop_size", type=int)
    p.add_argument("--loss_cs", "--loss_crop_size", type=int)
    p.add_argument("--debug_options", "--debug", nargs="*", default=[])
    p.add_argument("--g_network", type=str)
    p.add_argument("--threads", type=int, default=6)
    p.add_argument("--min_lr", type=float)
    p.add_argument("--epochs", type=int, default=9001)
    p.add_argument("--compute_SSIM_anyway", action="store_true")
    p.add_argument("--freeze_generator", action="store_true")
    p.add_argument("--start_epoch", default=1, type=int)
    p.add_argument("--patience", type=int)
    p.add_argument("--reduce_lr_factor", type=float)
    p.add_argument("--validation_interval", default=1, type=int)
    p.add_argument("--test_interval", default=0, type=int)
    p.add_argument("--orig_data")
    p.add_argument("--validation_set_yaml")
    p.add_argument("--exp_mult_min", type=float)
    p.add_argument("--exp_mult_max", type=float)
    p.add_argument("--clean_data_dpath")
    p.add_argument("--clean_data_ratio", type=float)
    # discriminators (--d_activation/--d2_activation/--d*_loss_function are
    # parsed and unused, as in the JAX trainer)
    p.add_argument("--d_activation", type=str, default="PReLU")
    p.add_argument("--d2_activation", type=str, default="PReLU")
    p.add_argument("--d_funit", type=int, default=32)
    p.add_argument("--d2_funit", type=int, default=32)
    p.add_argument("--d_model_path")
    p.add_argument("--d2_model_path")
    p.add_argument("--d_loss_function", type=str, default="MSE")
    p.add_argument("--d2_loss_function", type=str, default="MSE")
    p.add_argument("--d_lr", type=float)
    p.add_argument("--d2_lr", type=float)
    p.add_argument("--weight_D1", type=float)
    p.add_argument("--weight_D2", type=float)
    p.add_argument("--d_network", type=str, default="Hul112Disc")
    p.add_argument("--d2_network", type=str, default="Hul112Disc")
    p.add_argument("--not_conditional", action="store_true")
    p.add_argument("--not_conditional_2", action="store_true")
    p.add_argument("--discriminator_advantage", type=float, default=0.0)
    p.add_argument("--discriminator2_advantage", type=float, default=0.0)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16: bf16 forward and backward, fp32 master "
                        "weights, optimizer and loss")
    p.add_argument("--remat", action="store_true",
                   help="recompute the generator forward in the backward "
                        "(torch.utils.checkpoint): less activation memory")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each batch into N sequential microbatches and "
                        "apply ONE averaged update (~1/N the activation "
                        "memory). Must divide --batch_size")
    p.add_argument("--log_interval", type=int, default=1,
                   help="print per-batch generator losses every N batches "
                        "(1 = reference parity). N>1 also defers the "
                        "device->host metric readback between prints; epoch "
                        "means stay exact through sums kept on the device")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--cache_images", action="store_true",
                   help="decode training crops once and serve from RAM "
                        "(small datasets)")
    p.add_argument("--device_cache", type=int, default=0,
                   help="hold N training crop pairs on the device and augment "
                        "them there (rot90/flips/exp_mult); a background "
                        "thread re-draws a share of them each epoch. 0 = host "
                        "loader. Falls back to the host loader for "
                        "--clean_data_ratio and host-only augmentations")
    p.add_argument("--checkpoint_interval", type=int, default=1,
                   help="save the generator every N epochs instead of every "
                        "epoch (reference parity: 1). New-best epochs always "
                        "save, and stops (time_limit/min_lr/SIGTERM) force a "
                        "final save. 0 = stops/final only")
    p.add_argument("--device_cache_refresh", type=float, default=0.25,
                   help="share of the device cache re-drawn (new ISO pair and "
                        "crop position) per epoch; 0 = never")
    p.add_argument("--msssim_warmup_epochs", type=int, default=0,
                   help="train the first N epochs with MSE before switching "
                        "to the configured loss. MS-SSIM's relu'd product "
                        "has zero gradient whenever any scale's cs term goes "
                        "negative, and a randomly initialized generator can "
                        "start in that dead zone. Default 0 = reference "
                        "parity.")
    p.add_argument("--coordinator", help="multi-host: not ported (ROADMAP item 9)")
    p.add_argument("--num_processes", type=int,
                   help="multi-host: not ported (ROADMAP item 9)")
    p.add_argument("--process_id", type=int,
                   help="multi-host: not ported (ROADMAP item 9)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu when asked)")
    return p


def check_ported(args) -> None:
    """Refuse what this slice of the port does not run, naming where it is
    queued in ROADMAP.md."""
    for flag, weight, network in (("--d_network", args.weight_D1, args.d_network),
                                  ("--d2_network", args.weight_D2, args.d2_network)):
        if (weight or 0) > 0 and network not in HUL_DISCS:
            raise NotImplementedError(
                f"{flag} {network}: the port's discriminators are the Hul "
                f"family {sorted(HUL_DISCS)}; the rest of the model zoo is "
                f"ROADMAP item 7")
    if args.g_network != "UtNet":
        raise NotImplementedError(
            f"--g_network {args.g_network}: the port trains UtNet only; the "
            f"rest of the model zoo is ROADMAP item 7")
    if args.coordinator or args.num_processes or args.process_id is not None:
        raise NotImplementedError(
            "--coordinator/--num_processes/--process_id: multi-host training "
            "is not ported yet (ROADMAP item 9)")


def get_test_reserve_list(test_reserve):
    """yaml path / '0' / plain list (nn_common.get_test_reserve_list)."""
    if test_reserve and len(test_reserve) == 1:
        if str(test_reserve[0]).endswith(".yaml"):
            with open(test_reserve[0], "r") as fp:
                return yaml.safe_load(fp)
        if test_reserve[0] == "0":
            return []
    return list(test_reserve or [])


def delete_outperformed_models(dpath: str, keepers: set, model_t: str = "generator",
                               keep_all_output_images: bool = False):
    """Remove checkpoints / val image dirs for epochs not in keepers
    (nn_train.py:95-116 parity, .npz extension)."""
    removed = []
    for fn in os.listdir(dpath):
        fpath = os.path.join(dpath, fn)
        if fn in ("val", "testimages") and not keep_all_output_images:
            for subdir in os.listdir(fpath):
                if subdir.isdigit() and int(subdir) not in keepers:
                    shutil.rmtree(os.path.join(fpath, subdir))
                    removed.append(os.path.join(fpath, subdir))
            continue
        if not fn.startswith(f"{model_t}_"):
            continue
        stem = fn.split("_")[1].split(".")[0]
        if stem.isdigit() and int(stem) not in keepers:
            os.remove(fpath)
            removed.append(fpath)
    return removed


class GracefulShutdown:
    """Cooperative SIGTERM/SIGINT handling for preemptible training.

    The first signal sets a flag the epoch loop polls at batch boundaries:
    the step in flight completes, a full checkpoint (params + optimizer
    state) is written, and main() returns. A second signal restores the
    previous disposition and re-raises, so a wedged run can still be
    killed. Handlers install only from the main thread; elsewhere
    ``install`` does nothing and the flag never fires.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._prev = {}
        self.requested = False

    def install(self):
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in self.SIGNALS:
            self._prev[sig] = signal.signal(sig, self._handle)

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def _handle(self, signum, frame):
        if self.requested:  # second signal: stop cooperating
            self.restore()
            signal.raise_signal(signum)
            return
        self.requested = True
        sys.stderr.write(f"\n[signal {signum}] finishing current batch, "
                         "then checkpointing and exiting "
                         "(send again to force)\n")


class AsyncCheckpointer:
    """Overlap a checkpoint's device->host copy and file write with the
    next epoch's steps.

    ``submit`` snapshots the tensors on the device (``clone()``: the next
    step updates the live ones in place) and hands the snapshot to one
    writer thread, which copies it to the host and writes the ``.npz``.
    One save is in flight at a time, which bounds host memory and keeps
    the files in order. ``join()`` waits for it and re-raises the writer's
    error: a checkpoint that failed to write must not pass silently."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, save_fn, tensors) -> None:
        """``save_fn(snapshot)`` on the writer thread; ``tensors`` is a
        dict of lists or dicts of tensors and plain values."""
        self.join()

        def snap(v):
            if isinstance(v, torch.Tensor):
                return v.detach().clone()
            if isinstance(v, dict):
                return {k: snap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [snap(x) for x in v]
            return v

        snapshot = snap(tensors)

        def work():
            try:
                save_fn(snapshot)
            except BaseException as e:  # noqa: BLE001 — re-raised in join
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e


def init_model(funit: int, activation: str, seed: int) -> UtNet:
    """UtNet with torch's default init, drawn on the CPU from a generator
    seeded with ``seed`` (the same weights whatever the device)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return UtNet(funit, activation)


class GeneratorWrapper:
    """A UtNet, its optimizer and its steps' forward (reference Generator,
    nn_common.py:163-272)."""

    def __init__(self, args, weights, apply_fn, printer, device):
        self.apply_fn = apply_fn
        self.weights = steps.normalize_weights(weights)
        self.device = device
        opt_leaves = params = None
        self.resume_epoch = None
        if args.g_model_path:
            fpath = params_io.complete_path(args.g_model_path,
                                            args.models_dpath, "generator")
            if fpath.endswith(".npz"):
                tree = params_io.load_npz(fpath)
                params = tree["params"] if "params" in tree else tree
                opt_leaves = tree.get("opt")
                self.resume_epoch = tree.get("epoch")
                model = params_io.generator_from_state_dict(
                    params_io.state_dict_from_jax(params), args.g_activation)
            else:
                model = params_io.load_generator(fpath, args.g_activation)
        else:
            model = init_model(args.g_funit, args.g_activation, args.seed)
        model = model.to(device)
        opt = steps.make_optimizer(model, args.g_lr, args.beta1)
        if opt_leaves is not None:
            self.restore_opt(opt, model, opt_leaves, params)
            printer.print(f"Restored optimizer state (resume from epoch "
                          f"{self.resume_epoch})")
        self.state = steps.TrainState(model, opt)
        self.loss = {"weighted": 1.0}

    @staticmethod
    def restore_opt(opt, model, leaves, params) -> None:
        """Load a checkpoint's optimizer ``leaves`` (its params tree
        ``params``) into ``opt``, the optimizer of ``model``."""
        count, hyper, inner, moments = params_io.opt_from_leaves(leaves, params)
        opt.set_hyper(**hyper)
        opt.count, opt.inner_count = count, inner
        names = dict(model.named_parameters())
        for name, sd in moments.items():
            for key, buf in zip(names, opt.moments(name)):
                buf.copy_(sd[key].reshape(buf.shape))

    @torch.no_grad()
    def infer(self, x: torch.Tensor) -> torch.Tensor:
        """The forward at the steps' precision (no TF32)."""
        with _tf32(False):
            return self.apply_fn(self.state.model, x)

    def get_loss(self, pretty_printed=False, component="weighted"):
        if pretty_printed:
            return ", ".join(f"{k}: {v:.3f}" for k, v in self.loss.items()
                             if v != 1)
        return self.loss.get(component, 1.0)

    def save_model(self, model_dir, epoch, name="generator",
                   checkpointer: Optional[AsyncCheckpointer] = None):
        """Checkpoint params + optimizer leaves + epoch in the JAX trainer's
        layout. With ``checkpointer`` the copy to the host and the write
        overlap the next epoch; None = synchronous."""
        model, opt = self.state.model, self.state.opt
        names = [k for k, _ in model.named_parameters()]
        tensors = {"params": model.state_dict(),
                   "moments": {m: dict(zip(names, opt.moments(m)))
                               for m in params_io.OPT_MOMENTS}}
        count, inner, hyper = opt.count, opt.inner_count, opt.hyper
        fpath = os.path.join(model_dir, f"{name}_{epoch}.npz")

        def write(snap):
            tree = {"params": params_io.jax_from_state_dict(snap["params"]),
                    "state": None,
                    "opt": params_io.opt_leaves(count, hyper, inner, snap["moments"]),
                    "epoch": epoch}
            params_io.save(tree, fpath)

        if checkpointer is None:
            write(tensors)
        else:
            checkpointer.submit(write, tensors)


def to_device(batch_nhwc: np.ndarray, device: torch.device) -> torch.Tensor:
    """NHWC float32 numpy batch -> NCHW tensor on ``device``."""
    return torch.from_numpy(batch_nhwc).to(device).permute(0, 3, 1, 2).contiguous()


def _image_to_device(chw: np.ndarray, device: torch.device) -> torch.Tensor:
    """One CHW float32 image -> a (1, C, H, W) tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(chw[None])).to(device)


def validate_generator(eval_step, gen, validation_set,
                       output_to_dir: Optional[str] = None) -> float:
    """Per-epoch validation on fixed crop pairs (nn_train.py:51-71)."""
    from ..core import imgio

    losses = []
    for i in range(len(validation_set)):
        clean, noisy = validation_set[i]
        c, n = _image_to_device(clean, gen.device), _image_to_device(noisy, gen.device)
        metrics = eval_step(gen.state.model, c, n)
        if output_to_dir is not None:
            os.makedirs(output_to_dir, exist_ok=True)
            den = torch.clamp(gen.infer(n), 0, 1)[0].cpu().numpy()
            imgio.save_img(den, os.path.join(output_to_dir, f"{i}.tif"))
        losses.append(float(metrics["weighted"]))
    return statistics.mean(losses)


def test_generator(gen, test_set, output_to_dir: Optional[str] = None) -> float:
    """Whole-image test (nn_train.py:73-93) on the device."""
    from ..core import imgio

    losses = []
    for i in range(len(test_set)):
        clean, noisy = test_set[i]
        c, n = _image_to_device(clean, gen.device), _image_to_device(noisy, gen.device)
        with torch.no_grad():
            den = torch.clamp(gen.infer(n), 0, 1)
            total, _ = steps._quality_losses(den, c, gen.weights)
        if output_to_dir is not None:
            os.makedirs(output_to_dir, exist_ok=True)
            imgio.save_img(den[0].cpu().numpy(),
                           os.path.join(output_to_dir, f"{i}.tif"))
        losses.append(float(total))
    return statistics.mean(losses)


def main(argv=None):
    """Train; returns the experiment directory."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    debug_options = [o for o in args.debug_options if o in DEBUG_OPTIONS]

    weights = {"SSIM": args.weight_SSIM or 0, "MSSSIM": args.weight_MSSSIM or 0,
               "L1": args.weight_L1 or 0, "MSE": args.weight_MSE or 0,
               "D1": args.weight_D1 or 0, "D2": args.weight_D2 or 0}
    weights = steps.normalize_weights(weights)
    use_d = weights["D1"] > 0
    use_d2 = weights["D2"] > 0

    # the reference supplies learning rates via its preset configs
    # (configs/train_conf_*.yaml g_lr) — fail early without one
    if args.g_lr is None:
        sys.exit("error: --g_lr is required (set it directly or load a "
                 "preset, e.g. --config nind_denoise_tpu_torch/configs/"
                 "train_conf_utnet_std.yaml)")
    if (use_d and args.d_lr is None) or (use_d2 and args.d2_lr is None):
        sys.exit("error: --d_lr/--d2_lr are required when the corresponding "
                 "discriminator weight is non-zero")

    expname = (datetime.datetime.now().isoformat()[:-10] + "_"
               + "_".join(sys.argv).replace("/", "-"))[:255]
    model_dir = os.path.join(args.models_dpath, expname)
    os.makedirs(model_dir, exist_ok=True)
    p = Printer(file_path=os.path.join(model_dir, "train.log"))
    jsonsaver = json_saver.JSONSaver(os.path.join(model_dir, "trainres.json"),
                                     step_type="epoch")
    p.print(args)
    p.print("cmd: python3 " + " ".join(sys.argv))

    args.test_reserve = get_test_reserve_list(args.test_reserve)
    p.print(f"test_reserve: {args.test_reserve}")

    if (args.min_crop_size is None or args.min_crop_size == 0) \
            and "check_dataset" in debug_options:
        args.min_crop_size = args.cs
    dataset = ds_mod.DenoisingDataset(
        args.train_data, test_reserve=args.test_reserve, cs=args.cs,
        min_crop_size=args.min_crop_size, exp_mult_min=args.exp_mult_min or 1,
        exp_mult_max=args.exp_mult_max or 1, seed=args.seed,
        cache_images=args.cache_images)
    if args.loss_cs is None:
        args.loss_cs = dataset.min_crop_size
        if args.loss_cs is None:
            raise ValueError("--loss_cs is unset and the dataset directory "
                             "name gives no minimum crop size")
    if args.cs is None:
        args.cs = dataset.cs
    if "short_run" in debug_options:
        dataset.dataset = dataset.dataset[:3 * args.batch_size]

    if args.clean_data_ratio and args.clean_data_ratio > 0:
        cc = ds_mod.CleanCleanDataset(args.clean_data_dpath, cs=args.cs,
                                      seed=args.seed)
        bs_clean = max(1, int(args.batch_size * args.clean_data_ratio))
        bs_std = args.batch_size - bs_clean
        p.print(f"Initialized clean dataset of size {len(cc)}. "
                f"Clean batch_size = {bs_clean}")
        clean_loader = ds_mod.Loader(cc, bs_clean, num_threads=1, seed=args.seed)
        if len(clean_loader) == 0:
            raise SystemExit(
                f"clean dataset ({len(cc)} crops) is smaller than the clean "
                f"batch size {bs_clean}; add data or lower --clean_data_ratio")
        clean_iter = iter(clean_loader)
    else:
        clean_loader = clean_iter = None
        bs_clean, bs_std = 0, args.batch_size

    loader = ds_mod.Loader(dataset, bs_std, shuffle=True, drop_last=True,
                           num_threads=max(1, min(args.threads, 4)), seed=args.seed)

    # ---- device-resident data path (--device_cache) ----
    device_cache = None
    if args.device_cache > 0:
        from . import device_cache as dc_mod

        if bs_clean > 0:
            p.print("Warning: --device_cache is incompatible with "
                    "--clean_data_ratio (host-side batch mixing); using the "
                    "host loader")
        elif not dc_mod.supports(dataset):
            p.print("Warning: --device_cache cannot express this dataset's "
                    "host-side augmentations (JPEG/noise); using the host "
                    "loader")
        else:
            t0 = time.time()
            device_cache = dc_mod.DeviceEpochCache(
                dataset, args.device_cache, device=device, seed=args.seed,
                refresh_frac=args.device_cache_refresh,
                threads=max(1, min(args.threads, 4)))
            p.print(f"Device cache: {len(device_cache)} crop pairs on the device "
                    f"({time.time() - t0:.1f}s fill); refresh "
                    f"{args.device_cache_refresh:.0%}/epoch")
            device_cache.start_refresh()

    # ---- models + steps ----
    apply_fn = steps.bf16_apply if args.compute_dtype == "bfloat16" else steps.plain_apply
    gen = GeneratorWrapper(args, weights, apply_fn, p, device)
    if gen.resume_epoch is not None and args.start_epoch == 1:
        args.start_epoch = int(gen.resume_epoch) + 1
        p.print(f"Resuming at epoch {args.start_epoch}")

    # the discriminators stay fp32 under --compute_dtype bfloat16, as in JAX
    discs = []
    if use_d:
        discs.append(DiscriminatorWrapper(
            args, network=args.d_network, funit=args.d_funit, lr=args.d_lr,
            conditional=not args.not_conditional, seed=args.seed + 1,
            advantage=args.discriminator_advantage, patience=args.patience,
            model_path=args.d_model_path, keyword="discriminator", device=device))
    if use_d2:
        discs.append(DiscriminatorWrapper(
            args, network=args.d2_network, funit=args.d2_funit, lr=args.d2_lr,
            conditional=not args.not_conditional_2, seed=args.seed + 2,
            advantage=args.discriminator2_advantage, patience=args.patience,
            model_path=args.d2_model_path, keyword="discriminator2", device=device))
    # slot the fooling terms by identity (D1/D2), not list position: a
    # D2-only run must reach the weight_D2 term
    disc_fns = [None, None]
    for d in discs:
        disc_fns[0 if d.wname == "D1" else 1] = d.pred_fn

    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        sys.exit(f"error: --grad_accum {args.grad_accum} must divide "
                 f"--batch_size {args.batch_size}")
    train_step = steps.make_generator_train_step(
        apply_fn, weights, args.loss_cs,
        compute_ssim_anyway=args.compute_SSIM_anyway, remat=args.remat,
        grad_accum=args.grad_accum, disc_fns=tuple(disc_fns))
    warmup_step = steps.make_generator_train_step(
        apply_fn, {"MSE": 1.0}, args.loss_cs, remat=args.remat,
        grad_accum=args.grad_accum) if args.msssim_warmup_epochs > 0 else None
    eval_step = steps.make_generator_eval_step(
        apply_fn, weights, args.loss_cs,
        compute_ssim_anyway=args.compute_SSIM_anyway)

    # ---- validation / test data ----
    validation_set = None
    if args.validation_interval > 0:
        validation_set = ds_mod.ValidationDataset(args.validation_set_yaml,
                                                  cs=args.cs)
        val_dir = (lambda e: os.path.join(model_dir, "val", str(e))) \
            if "output_val_images" in debug_options else (lambda e: None)
        validation_loss = validate_generator(eval_step, gen, validation_set,
                                             val_dir(0))
        jsonsaver.add_res(0, {"validation_loss": validation_loss})
        p.print(f"Validation loss: {validation_loss}")
    else:
        validation_loss = None
    if args.test_interval > 0:
        test_set = ds_mod.TestDenoiseDataset(data_dpath=args.orig_data,
                                             sets=args.test_reserve)
        test_dir = (lambda e: os.path.join(model_dir, "testimages", str(e))) \
            if "output_test_images" in debug_options else (lambda e: None)

    with open(os.path.join(model_dir, "config.yaml"), "w") as fp:
        yaml.dump({k: v for k, v in vars(args).items()}, fp)

    start_time = time.time()
    loss_hist = collections.deque(maxlen=args.patience)
    frozen_generator = args.freeze_generator
    generator_lr = args.g_lr
    disc_lrs = [d.lr for d in discs]
    # the D/G schedule's draws, in the JAX loop's order (nn_train.py:325-350)
    sched_rng = random.Random(args.seed)
    # the discriminators' fuzzy targets and the device cache's augmentations
    draws = torch.Generator(device).manual_seed(args.seed)

    shutdown = GracefulShutdown()
    shutdown.install()
    ckpt_writer = AsyncCheckpointer()
    try:
        defer_metrics = args.log_interval > 1
        for epoch in range(args.start_epoch, args.epochs):
            loss_g, loss_g_ssim = [], []
            # deferred-readback mode: exact epoch means via device-side sums
            g_w_sum, g_ssim_sum, g_count, g_ssim_count = 0.0, 0.0, 0, 0
            loss_d_lists = [[] for _ in discs]
            epoch_start = time.time()
            batches_done = 0
            if device_cache is not None:
                batch_iter = device_cache.epoch_batches(args.batch_size, draws)
                n_batches = len(device_cache) // args.batch_size
            else:
                batch_iter = loader
                n_batches = len(loader)
            for iteration, (clean_b, noisy_b) in enumerate(batch_iter, 1):
                if shutdown.requested:
                    break
                if bs_clean > 0:
                    try:
                        cb = next(clean_iter)
                    except StopIteration:
                        p.print("Reloading clean_dataloader")
                        clean_iter = iter(clean_loader)
                        cb = next(clean_iter)  # non-empty: guarded at setup
                    clean_b = np.concatenate([clean_b, cb[0]])
                    noisy_b = np.concatenate([noisy_b, cb[1]])
                summary = f"Epoch {epoch} batch {iteration}/{n_batches}: "
                if device_cache is None:
                    clean, noisy = to_device(clean_b, device), to_device(noisy_b, device)
                else:
                    clean, noisy = clean_b, noisy_b

                # ---- stochastic D/G scheduling (nn_train.py:325-350) ----
                d_learns = []
                for di, d in enumerate(discs):
                    learns = (d.loss + d.advantage) > sched_rng.random() or frozen_generator
                    if learns:
                        d.learn(clean, noisy, gen, args.loss_cs, generator=draws)
                        loss_d_lists[di].append(d.loss)
                        summary += (f"loss {d.wname}: {d.loss:.4f} "
                                    f"({d.predictions_range}) ")
                    d_learns.append(learns)
                if not discs:
                    g_learns = not frozen_generator
                else:
                    avg = statistics.mean(d.loss + d.advantage
                                          for d, l in zip(discs, d_learns) if l) \
                        if any(d_learns) else 0.0
                    g_learns = not frozen_generator and (
                        not any(d_learns) or avg < sched_rng.random())
                if g_learns:
                    active_step = warmup_step if (warmup_step is not None and
                                                  epoch - args.start_epoch <
                                                  args.msssim_warmup_epochs) \
                        else train_step
                    metrics = active_step(gen.state, clean, noisy)
                    if defer_metrics:
                        g_w_sum = g_w_sum + metrics["weighted"]
                        g_count += 1
                        if "SSIM" in metrics:
                            g_ssim_sum = g_ssim_sum + metrics["SSIM"]
                            g_ssim_count += 1
                        if iteration % args.log_interval == 0:
                            gen.loss = {k: float(v) for k, v in metrics.items()}
                            summary += (f"loss G: "
                                        f"{gen.get_loss(pretty_printed=True)}")
                    else:
                        gen.loss = {k: float(v) for k, v in metrics.items()}
                        loss_g.append(gen.loss["weighted"])
                        if "SSIM" in gen.loss:
                            loss_g_ssim.append(gen.loss["SSIM"])
                        summary += f"loss G: {gen.get_loss(pretty_printed=True)}"
                elif frozen_generator and discs:
                    frozen_generator = discs[0].loss > 0.33 and \
                        (len(discs) < 2 or discs[1].loss > 0.33)
                if not defer_metrics or iteration % args.log_interval == 0 \
                        or any(d_learns):
                    p.print(summary)
                batches_done = iteration

            if shutdown.requested:
                # preemption checkpoint: --g_model_path <file> resumes at
                # epoch+1 (the partial epoch counts as done)
                p.print(f"Graceful shutdown: checkpointing epoch {epoch} "
                        f"after {batches_done}/{n_batches} batches")
                for d in discs:
                    d.save_model(model_dir, epoch, d.keyword)
                gen.save_model(model_dir, epoch)
                p.print(f"Checkpoint saved; resume with --g_model_path "
                        f"{os.path.join(model_dir, f'generator_{epoch}.npz')}")
                return model_dir

            # retention must see a consistent directory: wait for the
            # previous epoch's checkpoint write before scanning
            ckpt_writer.join()
            removed = delete_outperformed_models(
                model_dir, keepers=jsonsaver.get_best_steps(), model_t="generator",
                keep_all_output_images="keep_all_output_images" in debug_options)
            if removed:
                p.print(f"delete_outperformed_models removed {removed}")

            if args.validation_interval > 0 and epoch % args.validation_interval == 0:
                validation_loss = validate_generator(eval_step, gen,
                                                     validation_set,
                                                     val_dir(epoch))
                jsonsaver.add_res(epoch, {"validation_loss": validation_loss},
                                  write=False)
                p.print(f"Validation loss: {validation_loss}")
            if args.test_interval > 0 and epoch % args.test_interval == 0:
                test_loss = test_generator(gen, test_set, test_dir(epoch))
                jsonsaver.add_res(epoch, {"test_loss": test_loss}, write=False)

            if defer_metrics and g_count:
                loss_g = [float(g_w_sum) / g_count]
                if g_ssim_count:
                    loss_g_ssim = [float(g_ssim_sum) / g_ssim_count]
            p.print(f"Epoch {epoch} summary:")
            p.print("Time elapsed (s): %u (epoch), %u (total)"
                    % (time.time() - epoch_start, time.time() - start_time))
            if loss_g_ssim:
                jsonsaver.add_res(epoch, {"train_SSIM_loss": statistics.mean(loss_g_ssim)},
                                  write=False)
            if loss_g:
                avg_loss = statistics.mean(loss_g)
                p.print(f"Average weighted loss: {avg_loss}")
                jsonsaver.add_res(epoch, {"train_weighted_loss": avg_loss}, write=False)
                lr_loss = validation_loss if validation_loss is not None else avg_loss
                if loss_hist and max(loss_hist) < lr_loss:
                    gen.state, generator_lr = steps.decay_lr(gen.state,
                                                             args.reduce_lr_factor)
                    p.print(f"Generator learning rate updated to {generator_lr}")
                loss_hist.append(lr_loss)
                jsonsaver.add_res(epoch, {"gen_lr": generator_lr})
            else:
                p.print("Generator learned nothing")
            for di, d in enumerate(discs):
                if loss_d_lists[di]:
                    avg_d = statistics.mean(loss_d_lists[di])
                    p.print(f"Discriminator{di + 1} average normalized loss: {avg_d}")
                    disc_lrs[di] = d.update_learning_rate(avg_d)
                    d.save_model(model_dir, epoch, d.keyword)
            if device_cache is not None:
                # upload the background-refreshed block (if ready) and start
                # the next re-draw; a slow host leaves the augmentations
                # alone to re-randomize, never a stalled device
                device_cache.maybe_swap()
                device_cache.start_refresh()
            saved = False
            if not frozen_generator and args.checkpoint_interval > 0 and (
                    epoch % args.checkpoint_interval == 0
                    or epoch in jsonsaver.get_best_steps()):
                gen.save_model(model_dir, epoch, checkpointer=ckpt_writer)
                saved = True
            stopping = (args.time_limit
                        and args.time_limit < time.time() - start_time) or \
                (args.min_lr and generator_lr < args.min_lr and
                 all(lr is None or lr < args.min_lr for lr in disc_lrs))
            if stopping:
                if not saved and not frozen_generator:
                    gen.save_model(model_dir, epoch, checkpointer=ckpt_writer)
                p.print("Time is up" if args.time_limit
                        and args.time_limit < time.time() - start_time
                        else "Minimum learning rate reached")
                return model_dir
    finally:
        ckpt_writer.join()  # the last checkpoint must be on disk
        shutdown.restore()
    return model_dir


if __name__ == "__main__":
    main()
