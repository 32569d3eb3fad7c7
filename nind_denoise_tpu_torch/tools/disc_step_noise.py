"""How far one fp32 discriminator step lies from the same step in float64,
on the card and on the CPU, and where the card's distance comes from: a
conditional Hul112Disc at d_funit 32 (the trainer's default), trained N
steps on ``--device`` at batch 2 on seeded smooth 184 px crops (Adam, lr
1e-4, beta1 0.75, fuzzy targets), then, for each of ``--batches`` fresh
batches, one more step from that state several ways: float64 on
``--device`` (the reference); fp32 on the device with cuDNN and without
it; fp32 on the CPU; fp32 on the device with TF32 allowed in cuDNN and
cuBLAS, a planted precision fault that a check of the card's fp32 step has
to catch; and with ``--attribution`` the device's fp32 step with one op
class in float64 (convolutions, BatchNorm, PReLU) and both devices' with
BatchNorm by its fp32 formula.

    python -m nind_denoise_tpu_torch.tools.disc_step_noise [--ages 3,12]
        [--batches 24] [--pool 1,3,6] [--device cuda] [--attribution]

One JSON line per batch: each way's distance from the reference
(``measures``) and, for the device's steps, how close their fp32
convolutions come to their rounding bound (``conv_error_over_bound``).
Then one line per age that pools ``--pool`` consecutive batches and gives,
for each measure, the largest ratio of each way's distance to the CPU's
over the windows (the smallest for the TF32 step). Adam moves an element
whose gradient is rounding noise by up to the learning rate, so the
younger the state, the more a device's fp32 gradient error shows in its
step. About 5 s a batch with ``--attribution`` on an H100 machine's 8 CPU
cores, most of it the CPU's steps.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import time
import types

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter

from ..engine.tile_engine import _tf32
from ..train import gan, steps

LR = 1e-4
# way -> (on the CPU, cuDNN, TF32, the op that runs otherwise): fp32 steps
WAYS = {"card_fp32": (False, True, False, None),
        "card_fp32_without_cudnn": (False, False, False, None),
        "cpu_fp32": (True, True, False, None),
        "card_fp32_tf32": (False, True, True, None)}
# with --attribution: one op class in float64, or BatchNorm by its formula
ATTRIBUTION = {"card_fp32_batch_norm_float64": (False, True, False, "batch_norm"),
               "card_fp32_conv2d_float64": (False, True, False, "conv2d"),
               "card_fp32_prelu_float64": (False, True, False, "prelu"),
               "card_fp32_batch_norm_formula": (False, True, False, "formula"),
               "cpu_fp32_batch_norm_formula": (True, True, False, "formula")}


def crops(rng, b=2, hw=184):
    """(clean, noisy, generated) NCHW float32: smooth images, Gaussian
    noise, and a blur of the noisy crop standing in for the generator."""
    c = gaussian_filter(rng.random((b, 3, hw, hw)), (0, 0, 3, 3))
    c = (c - c.min()) / np.ptp(c)
    n = np.clip(c + rng.normal(0, 0.08, c.shape), 0, 1)
    f = gaussian_filter(n, (0, 0, 1, 1))
    return [torch.from_numpy(a.astype(np.float32)) for a in (c, n, f)]


def copy_as(d: gan.DiscriminatorWrapper, dtype, device=None) -> gan.DiscriminatorWrapper:
    """A copy of ``d`` in ``dtype`` (on ``device``) with its Adam state and
    counts (a deep copy of a torch optimizer keeps its state, not its
    attributes)."""
    c = copy.deepcopy(d)
    c.model.to(device, dtype)
    for st in c.optimizer.state.values():
        for k in list(st):
            st[k] = st[k].to(device, dtype)
    c.optimizer.count, c.optimizer.inner_count = d.optimizer.count, d.optimizer.inner_count
    c._step = steps.make_discriminator_train_step(c.model, c.optimizer)
    return c


def _float64(fn):
    """``fn`` with its tensor arguments in float64 and its result in the
    first one's dtype; running stats it updates are written back."""
    def run(x, *args, **kw):
        wide = [a.double() if torch.is_tensor(a) else a for a in args]
        y = fn(x.double(), *wide, **kw)
        with torch.no_grad():
            for a, w in zip(args, wide):
                if torch.is_tensor(a) and not a.requires_grad and a is not w:
                    a.copy_(w)
        return y.to(x.dtype)
    return run


def _bn_formula(x, running_mean, running_var, weight, bias, training, momentum, eps):
    """Train-mode BatchNorm by its formula in the input's dtype (reductions
    as torch's ``mean`` makes them), the running stats updated as torch's."""
    if not training:
        raise ValueError("the formula is for train mode")
    n = x.numel() // x.shape[1]
    mean = x.mean((0, 2, 3))
    var = (x - mean[None, :, None, None]).square().mean((0, 2, 3))
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var * (n / (n - 1)), alpha=momentum)
    scale = weight * torch.rsqrt(var + eps)
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] + bias[None, :, None, None]


@contextlib.contextmanager
def op_as(op):
    """Within: ``torch.nn.functional.<op>`` in float64, or BatchNorm by its
    formula (``op`` "formula"), or nothing changed (None)."""
    name = {"formula": "batch_norm"}.get(op, op)
    if name is None:
        yield
        return
    keep = getattr(F, name)
    setattr(F, name, _bn_formula if op == "formula" else _float64(keep))
    try:
        yield
    finally:
        setattr(F, name, keep)


@contextlib.contextmanager
def recording_convs(out):
    """Within: every ``torch.nn.functional.conv2d`` call appends [input,
    weight, bias, stride, padding, dilation, groups, output] to ``out``,
    copies (an optimizer step updates the weights in place), and the
    gradient that reaches its output, once the backward pass does."""
    keep = F.conv2d

    def rec(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = keep(x, w, b, stride, padding, dilation, groups)
        r = [x.detach().clone(), w.detach().clone(), None if b is None else b.detach().clone(),
             stride, padding, dilation, groups, y.detach().clone()]
        if y.requires_grad:
            y.register_hook(lambda g: r.append(g.detach().clone()))
        out.append(r)
        return y

    F.conv2d = rec
    try:
        yield
    finally:
        F.conv2d = keep


def _over(got, exact, mag, k, unit):
    """max |got - exact| / (gamma_k mag + u |exact|), gamma_k = k u / (1 - k u)."""
    bound = k * unit / (1 - k * unit) * mag + unit * exact.abs()
    return ((got.double() - exact).abs() / bound.clamp_min(1e-300)).max().item()


def conv_error_over_bound(records, unit=2.0 ** -24):
    """How close the recorded convolutions come to the rounding bound of
    any order of summation in their precision: for each pass, the largest
    over the records and their elements of |result - float64 result| over
    gamma_K (the same sum of magnitudes) + u |float64 result|, where K is
    the terms of one element and gamma_K = K u / (1 - K u). "forward" is
    the output the records hold (bias included); where a record holds its
    output's gradient, "input_grad" (K = Cout kh kw) and "weight_grad" (K =
    N Ho Wo) recompute the backward in the records' dtype under the
    trainer's TF32 setting. Each pass of an fp32 convolution reads below
    1 whatever its algorithm sums in what order; operands rounded to TF32
    or bf16 read far above it."""
    worst = {}
    for x, w, b, stride, padding, dilation, groups, y, *dy in records:
        conv = lambda a, c, d=None: F.conv2d(a, c, d, stride, padding, dilation, groups)  # noqa: E731
        x64, w64 = x.double(), w.double()
        b64 = None if b is None else b.double()
        k = w.shape[1] * w.shape[2] * w.shape[3] + (b is not None)
        got = {"forward": _over(y, conv(x64, w64, b64),
                                conv(x64.abs(), w64.abs(), None if b is None else b64.abs()),
                                k, unit)}
        if dy:
            xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
            with steps._tf32(False):
                gx, gw = torch.autograd.grad(conv(xs, ws), (xs, ws), dy[0])
            xs, ws = x64.clone().requires_grad_(), w64.clone().requires_grad_()
            ex, ew = torch.autograd.grad(conv(xs, ws), (xs, ws), dy[0].double())
            xs, ws = x64.abs().requires_grad_(), w64.abs().requires_grad_()
            mx, mw = torch.autograd.grad(conv(xs, ws), (xs, ws), dy[0].double().abs())
            got["input_grad"] = _over(gx, ex, mx, w.shape[0] * w.shape[2] * w.shape[3], unit)
            got["weight_grad"] = _over(gw, ew, mw, y.shape[0] * y.shape[2] * y.shape[3], unit)
        for key, v in got.items():
            worst[key] = max(worst.get(key, 0.0), v)
    return worst


@contextlib.contextmanager
def bounding_convs(bound):
    """Within: the convolutions run are recorded; on leaving, the dict
    ``bound`` keeps, pass by pass, the largest ``conv_error_over_bound``
    of them and of what it held. None: nothing is recorded."""
    if bound is None:
        yield
        return
    recs = []
    with recording_convs(recs):
        yield
    for k, v in conv_error_over_bound(recs).items():
        bound[k] = max(bound.get(k, 0.0), v)


@contextlib.contextmanager
def planted_tf32(on=True):
    """Within, if ``on``: the train steps allow TF32 in cuDNN and cuBLAS
    where they turn it off (``train.steps._tf32``), a planted precision
    fault."""
    keep = steps._tf32
    if on:
        steps._tf32 = lambda allow: _tf32(True)
    try:
        yield
    finally:
        steps._tf32 = keep


def step_once(d, batch, draws, device, dtype=torch.float32, cudnn=True, tf32=False, op=None,
              bound=None):
    """One discriminator step of a copy of ``d`` on ``device`` in ``dtype``
    (fake targets noisy): its parameters after the step, the step's summed
    gradients, float64 on the CPU, and its two losses; its convolutions
    held to their rounding bound into the dict ``bound`` (``bounding_convs``)."""
    x = copy_as(d, dtype, device)
    grads, opt_step = [], x.optimizer.step

    def spy():  # the summed gradients, which the step frees after the update
        grads.extend(p.grad.detach().cpu().double() for p in x.optimizer.params)
        return opt_step()

    x.optimizer.step = spy
    c, n, f = (t.to(device, dtype) for t in batch)
    off = contextlib.nullcontext() if cudnn else torch.backends.cudnn.flags(enabled=False)
    with off, planted_tf32(tf32), op_as(op), bounding_convs(bound):
        losses = x._step(c, f, n, True, draws=tuple(t.to(device, dtype) for t in draws))[:2]
    return ([p.detach().cpu().double() for p in x.model.parameters()], grads,
            [float(v) for v in losses])


def spread(step, ref, lr=LR):
    """Sums, over every element, of one step's distance from the reference
    step ``ref`` (both what ``step_once`` returns), which pool over batches
    by adding them up."""
    dp = torch.cat([(a - b).flatten() for a, b in zip(step[0], ref[0])]) / lr
    dg = torch.cat([(a - b).flatten() for a, b in zip(step[1], ref[1])])
    g = torch.cat([b.flatten() for b in ref[1]])
    return {"n": dp.numel(), "dg2": dg.square().sum().item(), "g2": g.square().sum().item(),
            "dp2": dp.square().sum().item(), "dp_max": dp.abs().max().item(),
            "over": (dp.abs() > 0.01).sum().item(),
            "loss": max(abs(a - b) for a, b in zip(step[2], ref[2]))}


def measures(sums):
    """The distance of a list of ``spread`` sums, pooled: the gradients'
    relative to their norm, the parameters' RMS and largest difference
    over the learning rate, the share more than 1 % of it apart, and the
    losses' largest difference."""
    t = {k: sum(s[k] for s in sums) for k in ("n", "dg2", "g2", "dp2", "over")}
    return {"grad_rel": math.sqrt(t["dg2"] / t["g2"]),
            "param_rms_over_lr": math.sqrt(t["dp2"] / t["n"]),
            "param_max_over_lr": max(s["dp_max"] for s in sums),
            "param_share_over_lr_1pct": t["over"] / t["n"],
            "loss_abs_diff": max(s["loss"] for s in sums)}


def summary(rows, pool, ways):
    """Over windows of ``pool`` consecutive batches: the largest ratio of
    each way's measure to the CPU's for the correct ways, the smallest for
    the TF32 step."""
    out = {}
    for lo in range(0, len(rows) - pool + 1, pool):
        w = rows[lo:lo + pool]
        m = {way: measures([r[way] for r in w]) for way in ways}
        for way in ways:
            pick = min if way == "card_fp32_tf32" else max
            for k, v in m[way].items():
                r = v / max(m["cpu_fp32"][k], 1e-300)
                key = f"{way}_over_cpu"
                out.setdefault(key, {})
                out[key][k] = r if k not in out[key] else pick(out[key][k], r)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ages", default="3,12")
    p.add_argument("--batches", type=int, default=24)
    p.add_argument("--pool", default="1,3,6")
    p.add_argument("--d_funit", type=int, default=32)
    p.add_argument("--device", default="cuda")
    p.add_argument("--attribution", action="store_true",
                   help="also the card's step with one op class in float64 and "
                        "both devices' with BatchNorm by its formula")
    args = p.parse_args(argv)
    ways = {**WAYS, **(ATTRIBUTION if args.attribution else {})}
    dev = args.device
    rng = np.random.default_rng(0)
    d = gan.DiscriminatorWrapper(types.SimpleNamespace(beta1=0.75, models_dpath=None),
                                 "Hul112Disc", args.d_funit, LR, True, seed=1, device=dev)
    age = 0
    for target in sorted(int(a) for a in args.ages.split(",")):
        while age < target:
            c, n, f = (t.to(dev) for t in crops(rng))
            d._step(c, f, n, d.loss < 0.25, generator=torch.Generator(dev).manual_seed(age))
            age += 1
        rows, bounds = [], []
        for b in range(args.batches):
            batch = crops(rng)
            shape = d.model(torch.cat([batch[1], batch[2]], 1).to(dev), frozen=True).shape
            draws = (torch.rand(shape), torch.rand(shape))
            ref = step_once(d, batch, draws, dev, torch.float64)
            row, secs, bound = {}, {}, {}
            for way, (on_cpu, cudnn, tf32, op) in ways.items():
                t0 = time.perf_counter()
                if op is None and not on_cpu:
                    bound[way] = {}
                row[way] = spread(step_once(d, batch, draws, "cpu" if on_cpu else dev,
                                            cudnn=cudnn, tf32=tf32, op=op,
                                            bound=bound.get(way)), ref)
                secs[way] = time.perf_counter() - t0
            rows.append(row)
            bounds.append(bound)
            print(json.dumps({"adam_steps_before": age, "batch": b, "seconds": secs,
                              "conv_error_over_bound": bound,
                              **{way: measures([s]) for way, s in row.items()}}), flush=True)
        print(json.dumps({"adam_steps_before": age, "d_funit": args.d_funit, "batch_size": 2,
                          "cs": 184, "device": dev, "batches": args.batches,
                          "cpu_threads": torch.get_num_threads(),
                          "conv_error_over_bound": {  # the largest, the TF32 step's least
                              way: {k: (min if way == "card_fp32_tf32" else max)(
                                  r[way][k] for r in bounds) for k in bounds[0][way]}
                              for way in bounds[0]},
                          "pooled": {pool: summary(rows, int(pool), ways)
                                     for pool in args.pool.split(",")}}), flush=True)


if __name__ == "__main__":
    main()
