"""Where a training step's time goes on the card, and what its variants
cost: UtNet funit 64 at ``train_conf_utnet_std.yaml``'s batch and crop
(30 x 184 px, MS-SSIM, AMSGrad), from a seeded init, on seeded smooth
crops with Gaussian noise.

    python -m nind_denoise_tpu_torch.tools.train_breakdown [--batch 30 --cs 184]

For fp32 (TF32 off) and bf16: the whole step in NCHW and in channels_last
(model and batch), interleaved over two rounds; the step cut into its
parts in NCHW (the forward without autograd, which takes K2 at level 1;
the forward with the loss; forward + loss + backward; the optimizer's
update alone); and in bf16 the step with ``--remat`` and with
``--grad_accum 2``. Times are warm, from CUDA events; peak memory from
``max_memory_allocated``. One JSON line per measurement, each with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..engine.tile_engine import _tf32
from ..train import loop, steps


def time_ms(fn, reps: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def batch(n: int, cs: int, device):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    clean = gaussian_filter(rng.random((n, 3, cs, cs)), (0, 0, 3, 3))
    clean = (clean - clean.min()) / np.ptp(clean)
    noisy = np.clip(clean + rng.normal(0, 0.08, clean.shape), 0, 1)
    return (torch.from_numpy(clean.astype(np.float32)).to(device),
            torch.from_numpy(noisy.astype(np.float32)).to(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=30)
    ap.add_argument("--cs", type=int, default=184)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_breakdown: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    clean, noisy = batch(args.batch, args.cs, "cuda")
    weights = {"MSSSIM": 1}

    def emit(**rec):
        print(json.dumps({**rec, "batch": args.batch, "cs": args.cs, "card": card}),
              flush=True)

    def setup(apply, fmt=torch.contiguous_format, **kw):
        model = loop.init_model(64, "PReLU", 1).cuda().to(memory_format=fmt)
        state = steps.TrainState(model, steps.make_optimizer(model, 1e-4, 0.75))
        step = steps.make_generator_train_step(apply, weights, args.cs, **kw)
        return state, step

    def whole(apply, fmt=torch.contiguous_format, **kw):
        state, step = setup(apply, fmt, **kw)
        c, n = clean.contiguous(memory_format=fmt), noisy.contiguous(memory_format=fmt)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(state, c, n))
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    applies = {"float32": steps.plain_apply, "bfloat16": steps.bf16_apply}
    layouts = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}
    for dtype, apply in applies.items():
        for rnd in range(2):
            for name, fmt in layouts.items():
                ms, peak = whole(apply, fmt)
                emit(what="step", dtype=dtype, layout=name, round=rnd, ms=ms,
                     crops_per_s=args.batch / ms * 1e3, peak_gib=peak)

        state, step = setup(apply)
        model, opt = state.model, state.opt
        crop = lambda t: steps.center_crop(t, args.cs)

        def forward():
            with torch.no_grad(), _tf32(False):
                apply(model, noisy)

        def forward_loss():
            with _tf32(False):
                gen = torch.clamp(apply(model, noisy), 0, 1)
                return steps._quality_losses(crop(gen), crop(clean),
                                             steps.normalize_weights(weights))[0]

        def forward_loss_backward():
            opt.zero_grad(set_to_none=True)
            with _tf32(False):
                forward_loss().backward()

        forward_loss_backward()
        parts = {"forward_no_grad_k2_level1": time_ms(forward),
                 "forward_loss": time_ms(forward_loss),
                 "forward_loss_backward": time_ms(forward_loss_backward),
                 "optimizer": time_ms(opt.step),
                 "step": time_ms(lambda: step(state, clean, noisy))}
        emit(what="parts", dtype=dtype, layout="nchw", ms=parts)
        del model, opt, state

    for name, kw in (("remat", {"remat": True}), ("grad_accum_2", {"grad_accum": 2})):
        ms, peak = whole(steps.bf16_apply, **kw)
        emit(what="step", dtype="bfloat16", layout="nchw", variant=name, ms=ms,
             crops_per_s=args.batch / ms * 1e3, peak_gib=peak)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
