"""How far one fp32 training step lands apart on the card and on the CPU,
and how far each lies from the same step in float64: UtNet funit 64 from
the trainer's seeded init (``--seed 123``), trained on the card for a few
steps of ``train_conf_utnet_std.yaml`` (batch 30, 184 px, MS-SSIM, AMSGrad,
lr 1e-4, beta1 0.75) on ``train_breakdown``'s seeded crops, then one step
at batch 2 on the card (fp32, TF32 off), on the CPU (fp32) and on the CPU
in float64.

    python -m nind_denoise_tpu_torch.tools.train_step_noise [--states 4,6,6,6,12,24]

For each trained state the step is taken twice: from the state's own
AMSGrad moments and counts (as the trainer resumes a checkpoint) and from
a fresh optimizer state (a first step, which moves each element by about
the learning rate whatever its gradient's size). Each pair of devices
reports the largest parameter difference over the learning rate and the
share of parameters apart by more than 1 % of it. Then: whether a step
repeats bit for bit on the card with ``cudnn.deterministic`` off and on,
and its time at batch 30 in fp32 and bf16; and one 3 x 3 conv of
(2, 64, 184, 184) in fp32 on the card and the CPU against float64
(forward, input gradient, weight gradient). One JSON line per
measurement, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import torch
import torch.nn.functional as F

from ..engine.tile_engine import _tf32
from ..train import loop, steps
from .train_breakdown import batch, time_ms

LR = 1e-4


@contextlib.contextmanager
def _deterministic(on: bool):
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _step_fn(apply=steps.plain_apply, cs=184):
    return steps.make_generator_train_step(apply, {"MSSSIM": 1}, cs)


def train_state(n_steps: int, clean, noisy):
    """The weights and optimizer state after ``n_steps`` fp32 steps on the
    card from the seeded init, on the CPU."""
    model = loop.init_model(64, "PReLU", 123).cuda()
    state = steps.TrainState(model, steps.make_optimizer(model, LR, 0.75))
    step = _step_fn()
    for _ in range(n_steps):
        step(state, clean, noisy)
    opt = state.opt
    return ({k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            {m: [b.detach().cpu().clone() for b in opt.moments(m)] for m in ("mu", "nu", "nu_max")},
            opt.count, opt.inner_count)


def one_step(trained, device, dtype, clean, noisy, resume: bool):
    """One step from ``trained``; the updated parameters in float64."""
    sd, moments, count, inner = trained
    model = loop.init_model(64, "PReLU", 123)
    model.load_state_dict(sd)
    model = model.to(device, dtype)
    opt = steps.make_optimizer(model, LR, 0.75)
    if resume:
        opt.count, opt.inner_count = count, inner
        for name, bufs in moments.items():
            for dst, src in zip(opt.moments(name), bufs):
                dst.copy_(src)
    _step_fn()(steps.TrainState(model, opt), clean.to(device, dtype), noisy.to(device, dtype))
    return [p.detach().cpu().double() for p in model.parameters()]


def apart(a, b) -> dict:
    d = torch.cat([(x - y).abs().flatten() for x, y in zip(a, b)])
    return {"param_max_over_lr": d.max().item() / LR,
            "share_over_lr_1pct": (d > LR / 100).double().mean().item()}


def conv_accuracy(device: str) -> list:
    """Max error over max magnitude of a 3 x 3 conv's output, input
    gradient and weight gradient in fp32 (TF32 off) against float64."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 184, 184, generator=g)
    w = torch.randn(64, 64, 3, 3, generator=g) / 24
    dy = torch.randn(2, 64, 184, 184, generator=g)

    def run(dtype, dev):
        xx = x.to(dev, dtype).clone().requires_grad_()
        ww = w.to(dev, dtype).clone().requires_grad_()
        with _tf32(False):
            y = F.conv2d(xx, ww, padding=1)
            y.backward(dy.to(dev, dtype))
        return [t.detach().cpu().double() for t in (y, xx.grad, ww.grad)]

    ref = run(torch.float64, "cpu")
    return [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(run(torch.float32, device), ref)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--states", default="4,6,6,6,12,24",
                    help="training steps before each compared step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_step_noise: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]

    def emit(**rec):
        print(json.dumps({**rec, "card": card}), flush=True)

    clean, noisy = batch(30, 184, "cuda")
    c2, n2 = clean[:2].cpu(), noisy[:2].cpu()
    trained = None
    for n in (int(s) for s in args.states.split(",")):
        trained = train_state(n, clean, noisy)
        rec = {"trained_steps": n}
        for resume in (True, False):
            cuda = one_step(trained, "cuda", torch.float32, c2, n2, resume)
            cpu = one_step(trained, "cpu", torch.float32, c2, n2, resume)
            f64 = one_step(trained, "cpu", torch.float64, c2, n2, resume)
            rec["resumed" if resume else "fresh"] = {
                "cuda_vs_cpu": apart(cuda, cpu), "cpu_vs_float64": apart(cpu, f64),
                "cuda_vs_float64": apart(cuda, f64)}
        emit(what="step_apart", **rec)

    for det in (False, True):
        with _deterministic(det):
            a = one_step(trained, "cuda", torch.float32, c2, n2, True)
            b = one_step(trained, "cuda", torch.float32, c2, n2, True)
        emit(what="step_repeats", cudnn_deterministic=det,
             max_abs_diff=max((x - y).abs().max().item() for x, y in zip(a, b)))
    for name, apply in (("float32", steps.plain_apply), ("bfloat16", steps.bf16_apply)):
        for det in (False, True, False, True):
            model = loop.init_model(64, "PReLU", 123).cuda()
            state = steps.TrainState(model, steps.make_optimizer(model, LR, 0.75))
            step = _step_fn(apply)
            with _deterministic(det):
                ms = time_ms(lambda: step(state, clean, noisy))
            emit(what="step_ms", dtype=name, cudnn_deterministic=det, batch=30, ms=ms)
    for device in ("cuda", "cpu"):
        emit(what="conv_fp32_rel_err", device=device,
             **dict(zip(("out", "input_grad", "weight_grad"), conv_accuracy(device))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
