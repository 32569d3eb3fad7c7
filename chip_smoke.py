#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nind_denoise_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (every line carries the card's name and power
limit as nvidia-smi reports them):

1. build every kernel in ``nind_denoise_tpu_torch/csrc`` (one nvcc each,
   all at once);
2. K2 (enc1) against its plain PyTorch version on the card, at the product
   batch (8 x 504 x 504, funit 64) in bf16 and fp32, at 2 x 104 x 136, and
   at the server's adapted (136 x 136) and tiny-path (104 x 104) tiles;
   each shape also times cuDNN's own level 1 (channels_last convolutions,
   PReLU, max pool) as the library yardstick;
3. RL against a loop of its plain iteration, at 2000 x 3000 x 3, sigma
   1, 10 iterations, plus the short-tail heights, sigma 3, a 6000-wide
   strip, a ragged 97 x 131, and one case of each route with its launch
   counts: sigma 6 and 10 on K1, 11 on K3 blurs, 22 on the plain blur; a
   batch of 3 that must equal its single runs bit for bit; K1's times at
   sigma 1 and 10 at 6 MP and at the server's (24, 480, 480) planes, with
   a sequence of cuDNN calls as their library yardstick, and each
   separable route's time per iteration at 6 MP;
4. K3 (the standalone Gaussian blur) against its plain version at
   2000 x 3000 x 3 for sigma 1, 3 and 21 (r = 63, the largest radius
   under the limit), at 97 x 131, 5 x 7 (smaller than its radius) and
   24 x 6000; its planar entry at (3, 2000, 3000) for R 30, 33 and 64,
   each timed beside a replicate pad and two depthwise convolutions; every
   radius 1-64 on a ragged 75 x 77 x 3 image and ragged (2, 75, 77)
   planes; sigma 22 must raise;
5. end to end: a seeded 16-bit 2000 x 3000 TIFF and a seeded funit-64 .npz
   checkpoint through ``denoise_cli --tiff-input`` in bf16 to a JPEG,
   with the kernel launch counts of that run; then a small image in fp32
   on the card and on the CPU, whose pre-encode uint8 images must agree to
   1 LSB;
6. serve: ``DenoiseService`` behind ``serve()`` on a loopback port, bf16,
   batch 8, cs 504 / ucs 480, driven with urllib: six 6 MP 16-bit PNGs
   that must equal the engine + RL run directly, bit for bit; 480 x 480
   requests, one at a time, then eight at once, coalesced, with one RL
   dispatch per group, each within 1 LSB of its serial response and the
   group's canvases within one bf16 ulp of each image's own run; 40
   free-running bursts of eight for the rates, and 8 more under the
   profiler for the device's busy share; an adapted and a tiny-image
   request; a reload to a second checkpoint;
7. the K2 and K1 inputs of every shape the serve traffic gave the kernels
   (kept by a wrapper that still launches once per call), each against
   the plain version at the limits of phases 2 and 3; then the batch
   witness: one tile in all eight slots against the tile alone, where K2
   must give every slot the tile's own bits and cuDNN is reported slot by
   slot.

Then a ``kernels`` line (per-launch times against each kernel's bound),
the card line and, last, ``{"ok": true, "device": {...}}``. Any failure,
a missing GPU or a failed build exits non-zero without that last line.
Times are warm, from CUDA events. Launch counts are read around the runs
of the product paths (the CLI and the server) only, with every count set
to 0 just before each run.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def emit(card: str, **rec) -> None:
    print(json.dumps({**rec, "card": card}), flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Warm per-call time from CUDA events over ``reps`` calls."""
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


def bound_ms(nbytes: float, flops: float, dtype: str):
    b, o = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def write_jax_checkpoint(path: str, funit: int, seed: int) -> None:
    """A funit-``funit`` UtNet in the JAX package's .npz params format
    (HWIO kernels, (I, 4*O) up-conv matrices, scalar PReLU ``a``), with
    torch-default-style uniform(+-1/sqrt(fan_in)) weights from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    arrays = {}

    def layer(key, shape, fan_in, cout, act=True):
        bound = 1.0 / math.sqrt(fan_in)
        arrays[f"{key}/w"] = rng.uniform(-bound, bound, shape).astype(np.float32)
        arrays[f"{key}/b"] = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
        if act:
            arrays[f"{key}/a"] = np.asarray(0.25, np.float32)

    def conv(key, cin, cout, k=3, act=True):
        layer(key, (k, k, cin, cout), cin * k * k, cout, act)

    def tconv(key, cin, cout):
        layer(key, (3, 3, cin, cout), cout * 9, cout)

    f = funit
    for i, (cin, c) in enumerate([(3, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f)], 1):
        conv(f"convs{i}/c0", cin, c)
        conv(f"convs{i}/c1", c, c)
    conv("bottom/c0", 8 * f, 16 * f)
    tconv("bottom/c1", 16 * f, 16 * f)
    for i, (cin, c) in enumerate([(16 * f, 8 * f), (8 * f, 4 * f), (4 * f, 2 * f)], 1):
        layer(f"up{i}", (cin, 4 * c), c * 4, c, act=False)
        tconv(f"tconvs{i}/c0", cin, c)
        tconv(f"tconvs{i}/c1", c, c)
    layer("up4", (2 * f, 4 * f), f * 4, f, act=False)
    tconv("tconvs4/c0", 2 * f, f)
    tconv("tconvs4/c1", f, f)
    conv("tconvs4/c2", f, 3, k=1, act=False)
    meta = np.frombuffer(json.dumps({}).encode(), dtype=np.uint8)
    np.savez(path, __pytree_meta__=meta, **arrays)


def enc1_vs_plain(torch, E, args):
    """K2 against its plain version on ``args``: (max abs error, limit)."""
    # the plain version in full fp32: no TF32 in cuDNN
    torch.backends.cudnn.allow_tf32 = False
    l1, l2 = E.enc1(*args)
    r1, r2 = E.enc1_reference(*args)
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = True
    err = max((l1.float() - r1.float()).abs().max().item(),
              (l2.float() - r2.float()).abs().max().item())
    scale = max(1.0, r1.float().abs().max().item())
    # fp32: only the order of the 27- and 576-term sums differs.
    # bf16: t0 and l1 are rounded to 8 mantissa bits; a sum-order
    # change can flip a t0 rounding, moving l1 by a few ulps, so
    # allow 4 bf16 ulps at the output's magnitude (4 * 2^-8).
    tol = (1e-4 if args[0].dtype == torch.float32 else 4 * 2 ** -8) * scale
    return err, tol


def rl_vs_plain(torch, R, d, taps, iters):
    """``iters`` K1 iterations from u = d against as many of its plain
    version, on (P, H, W) fp32 planes: (max abs error, limit)."""
    bufs = [torch.empty_like(d), torch.empty_like(d)]
    u = ref = d
    for i in range(iters):
        u = R.rl_iter(u, d, taps, out=bufs[i % 2])
        ref = R.rl_iter_reference(ref, d, taps.tolist())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(u).all()), f"rl {tuple(d.shape)}: non-finite output")
    # fp32, as the CPU tests; the kernel rounds like the plain version
    return (u - ref).abs().max().item(), 2e-5 * max(1.0, ref.abs().max().item())


def bf16_ulp(x: float) -> float:
    """One bfloat16 ulp (8 significant bits) at magnitude ``x`` > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def enc1_library(torch, args):
    """The call a PyTorch user makes for level 1: cuDNN's convolutions on
    channels_last tensors of the input's type, PReLU and max pool. It
    rounds after each convolution, not after each PReLU. A yardstick
    only: the port never calls it."""
    import torch.nn.functional as F

    x, w0, b0, a0, w1, b1, a1 = args
    cl = torch.channels_last
    x, w0, w1 = (t.contiguous(memory_format=cl) for t in (x, w0, w1))

    def run():
        t = F.prelu(F.conv2d(x, w0, b0), a0)
        l1 = F.prelu(F.conv2d(t, w1, b1), a1)
        return l1, F.max_pool2d(l1, 2)

    return run


def phase_enc1(torch, card):
    from nind_denoise_tpu_torch.ops import enc1 as E

    gen = torch.Generator().manual_seed(1)
    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        # the product batch, a ragged 104 x 136, and the two shapes the
        # server's adapted (cs 136) and tiny paths give K2
        for bsz, h, w in ((8, 504, 504), (2, 104, 136), (1, 136, 136), (1, 104, 104)):
            x = torch.rand(bsz, 3, h + 4, w + 4, generator=gen).to("cuda", dt)

            def u(*shape, fan_in):
                b = 1.0 / math.sqrt(fan_in)
                return ((torch.rand(*shape, generator=gen) * 2 - 1) * b).to("cuda", dt)

            args = (x, u(64, 3, 3, 3, fan_in=27), u(64, fan_in=27),
                    torch.full((1,), 0.25, device="cuda", dtype=dt),
                    u(64, 64, 3, 3, fan_in=576), u(64, fan_in=576),
                    torch.full((1,), 0.25, device="cuda", dtype=dt))
            err, tol = enc1_vs_plain(torch, E, args)
            check(err <= tol, f"enc1 {dtype} {bsz}x{h}x{w}: max err {err} > {tol}")
            # the plain version is timed as it was checked: without TF32
            torch.backends.cudnn.allow_tf32 = False
            item = 2 if dt == torch.bfloat16 else 4
            nbytes = item * (x.numel() + 64 * 27 + 64 * 576 + 130
                             + bsz * 64 * (h * w + (h // 2) * (w // 2)))
            flops = 2.0 * bsz * h * w * 64 * 576 + 2.0 * bsz * (h + 2) * (w + 2) * 64 * 27
            bms, by = bound_ms(nbytes, flops, dtype)
            reps = 10 if h == 504 else 50
            ms = time_ms(torch, lambda: E.enc1(*args), reps)
            plain = time_ms(torch, lambda: E.enc1_reference(*args), reps)
            # the library yardstick, fp32 without TF32 like the plain version
            library = enc1_library(torch, args)
            y1, y2 = library()
            r1, r2 = E.enc1_reference(*args)
            lib_err = max((y1.float() - r1.float()).abs().max().item(),
                          (y2.float() - r2.float()).abs().max().item())
            lib_ms = time_ms(torch, library, reps)
            rec = dict(phase="enc1", dtype=dtype, shape=[bsz, h, w], max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain, library_ms=lib_ms,
                       library_max_abs_err=lib_err, bound_ms=bms, bound_by=by)
            emit(card, **rec)
            out[(dtype, h, w)] = rec
    torch.backends.cudnn.allow_tf32 = True
    return out[("bfloat16", 504, 504)]


def rl_library(torch, d, taps):
    """A sequence of cuDNN calls for one RL iteration on (P, H, W): per
    blur a replicate pad and two depthwise 1-D convolutions (fp32 without
    TF32), twice, with the clamp, divide and multiply between. A yardstick
    only: the port never calls it."""
    import torch.nn.functional as F

    p = d.shape[0]
    r = (len(taps) - 1) // 2
    kv = torch.from_numpy(taps).to("cuda").reshape(1, 1, -1, 1).repeat(p, 1, 1, 1)
    kh = kv.reshape(p, 1, 1, -1)

    def blur(x):
        x = F.pad(x[None], (r, r, r, r), mode="replicate")
        return F.conv2d(F.conv2d(x, kv, groups=p), kh, groups=p)[0]

    return lambda: d * blur(d / torch.clamp(blur(d), min=1e-8))


def rl_time(torch, R, d, taps, reps):
    """K1's warm time, its plain version's, its library yardstick's and its
    bound on (P, H, W) planes at ``taps``, one iteration from u = d."""
    tt = torch.from_numpy(taps).to("cuda")
    out = torch.empty_like(d)
    nbytes = 3 * d.numel() * 4 + tt.numel() * 4
    r = (len(taps) - 1) // 2
    # two separable blurs (2 passes of 2r+1 mul+add), the ratio's max and
    # divide, the final multiply
    flops = d.numel() * (2 * 2 * 2 * (2 * r + 1) + 3)
    bms, by = bound_ms(nbytes, flops, "float32")
    rec = dict(ms=time_ms(torch, lambda: R.rl_iter(d, d, tt, out=out), reps),
               plain_ms=time_ms(torch, lambda: R.rl_iter_reference(d, d, taps),
                                max(2, reps // 4)),
               bound_ms=bms, bound_by=by)
    library = rl_library(torch, d, taps)
    torch.backends.cudnn.allow_tf32 = False
    rec.update(library_ms=time_ms(torch, library, max(2, reps // 4)),
               library_max_abs_err=(library() - R.rl_iter_reference(d, d, taps))
               .abs().max().item())
    torch.backends.cudnn.allow_tf32 = True
    return rec


def phase_rl(torch, card):
    """RL deblur on the card against its plain iteration, on each route:
    K1 (``fused``, R <= 32), K3 blurs (``separable_k3``, R <= 64) and the
    tap-unrolled torch blur (``separable_plain``), each with the launch
    counts and the route its radius picks; then K1's times."""
    from nind_denoise_tpu_torch.ops import gauss_blur as G
    from nind_denoise_tpu_torch.ops import rl_deblur as RL
    from nind_denoise_tpu_torch.ops import rl_fused as R

    gen = torch.Generator().manual_seed(2)
    tol = 2e-5  # fp32, as the CPU tests; the kernels round like the plain version
    expect = {"fused": lambda n: {"rl_iter": n, "gauss_blur": 0},
              "separable_k3": lambda n: {"rl_iter": 0, "gauss_blur": 2 * n},
              "separable_plain": lambda n: {"rl_iter": 0, "gauss_blur": 0}}
    product = None
    # the product shape, the short-tail heights, sigma 3, a 6000-wide strip,
    # a width that is no multiple of 4 (K1's scalar stores), then one case
    # of each route: sigma 6 (R 18) and 10 (R 30, the darktable plugin's
    # top) on K1, 11 (R 33) on K3, 22 (R 66) plain
    for (h, w, sigma, iters) in ((2000, 3000, 1.0, 10), (361, 140, 1.0, 10),
                                 (362, 140, 1.0, 10), (130, 260, 3.0, 10),
                                 (24, 6000, 1.0, 10), (97, 131, 2.0, 3),
                                 (300, 260, 6.0, 3), (300, 260, 10.0, 3),
                                 (300, 260, 11.0, 3), (260, 300, 22.0, 2)):
        img = (torch.rand(h, w, 3, generator=gen) + 0.05).to("cuda")
        taps = RL.gaussian_taps_np(sigma)
        route = RL.route_for(RL.psf_radius(sigma))
        before = {"rl_iter": R.launches, "gauss_blur": G.launches,
                  "route": RL.routes[route]}
        got = RL.rl_deblur(img, sigma, iters)
        torch.cuda.synchronize()
        launches = {"rl_iter": R.launches - before["rl_iter"],
                    "gauss_blur": G.launches - before["gauss_blur"]}
        check(launches == expect[route](iters) and RL.routes[route] == before["route"] + 1,
              f"rl {h}x{w} sigma {sigma}: route {route}, launches {launches}")
        d = img.permute(2, 0, 1).contiguous()
        u = d
        for _ in range(iters):
            u = R.rl_iter_reference(u, d, taps)
        ref = u.permute(1, 2, 0)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"rl {h}x{w}: non-finite output")
        check(err <= tol * max(1.0, ref.abs().max().item()),
              f"rl {h}x{w} sigma {sigma}: max err {err}")
        rec = dict(phase="rl_iter", shape=[h, w, 3], sigma=sigma, radius=len(taps) // 2,
                   route=route, iterations=iters, launches=launches, max_abs_err=err,
                   tol=tol)
        if product is None:
            rec.update(rl_time(torch, R, d, taps, 20))
            product = rec
        emit(card, **rec)
    batch = (torch.rand(3, 120, 176, 3, generator=gen) + 0.05).to("cuda")
    together = RL.rl_deblur(batch, 1.0, 10)
    for i in range(3):
        check(torch.equal(together[i], RL.rl_deblur(batch[i], 1.0, 10)),
              f"rl batch member {i} differs from its single run")
    emit(card, phase="rl_iter", check="batch of 3 equals its single runs bit for bit")

    # K1 where the operations bound it (sigma 10 at 6 MP) and at the
    # server's planes (a group of eight 480 x 480 images); one iteration
    # of each separable route at 6 MP
    img = (torch.rand(2000, 3000, 3, generator=gen) + 0.05).to("cuda")
    d = img.permute(2, 0, 1).contiguous()
    emit(card, phase="rl_iter_time", shape=[3, 2000, 3000], sigma=10.0,
         **rl_time(torch, R, d, RL.gaussian_taps_np(10.0), 10))
    planes = (torch.rand(24, 480, 480, generator=gen) + 0.05).to("cuda")
    emit(card, phase="rl_iter_time", shape=[24, 480, 480], sigma=1.0,
         **rl_time(torch, R, planes, RL.gaussian_taps_np(1.0), 50))
    for sigma in (11.0, 22.0):
        emit(card, phase="rl_route_time", shape=[2000, 3000, 3], sigma=sigma,
             route=RL.route_for(RL.psf_radius(sigma)), iterations=1,
             ms=time_ms(torch, lambda: RL.rl_deblur(img, sigma, 1), 3))
    return product


def blur_vs_plain(torch, got, ref, what):
    """K3's output against its plain version: (max abs error, limit); fails
    on a wrong shape, a non-finite value or an error above the limit, the
    JAX test's bar (0 when the kernel rounds like the plain version)."""
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 2e-6 * max(1.0, ref.abs().max().item())
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()) and err <= tol,
          f"{what}: max err {err} > {tol}, or a bad output")
    return err, tol


def blur_library(torch, x, taps, hwc=False):
    """K3's yardstick on (P, H, W) planes, or on (H, W, C) through a
    channels-first view (``hwc``): a replicate pad and two depthwise 1-D
    convolutions; the port never calls it."""
    import torch.nn.functional as F

    planes = x.permute(2, 0, 1) if hwc else x
    p = planes.shape[0]
    r = (len(taps) - 1) // 2
    kv = torch.from_numpy(taps).to("cuda").reshape(1, 1, -1, 1).repeat(p, 1, 1, 1)
    kh = kv.reshape(p, 1, 1, -1)

    def run():
        xp = F.pad(planes[None], (r, r, r, r), mode="replicate")
        y = F.conv2d(F.conv2d(xp, kv, groups=p), kh, groups=p)[0]
        return y.permute(1, 2, 0) if hwc else y

    return run


def blur_times(torch, kernel, plain, library, ref, r, reps):
    """K3's warm time beside its plain version's, its library yardstick's
    (fp32 without TF32, with its error against ``ref``) and its bound:
    8 bytes and 4(2r+1) flops an element."""
    torch.backends.cudnn.allow_tf32 = False
    lib_err = (library() - ref).abs().max().item()
    lib_ms = time_ms(torch, library, 20)
    torch.backends.cudnn.allow_tf32 = True
    bms, by = bound_ms(8 * ref.numel(), 4 * (2 * r + 1) * ref.numel(), "float32")
    return dict(ms=time_ms(torch, kernel, reps),
                plain_ms=time_ms(torch, plain, 3 if r > 9 else 10),
                library_ms=lib_ms, library_max_abs_err=lib_err, bound_ms=bms, bound_by=by)


def gauss_blur_radius_sweep(torch, card):
    """K3 at every radius 1-64 on a ragged HWC image and ragged planes,
    each template instance against the plain version."""
    from nind_denoise_tpu_torch.ops import gauss_blur as G
    from nind_denoise_tpu_torch.ops import rl_fused
    from nind_denoise_tpu_torch.ops.rl_deblur import gaussian_taps_np

    gen = torch.Generator().manual_seed(6)
    img = torch.rand(75, 77, 3, generator=gen).to("cuda")
    planes = torch.rand(2, 75, 77, generator=gen).to("cuda")
    worst = {"hwc": 0.0, "planes": 0.0}
    for r in range(1, G.MAX_RADIUS + 1):
        sigma = (r - 0.5) / 3  # ceil(3 sigma) = r
        taps = gaussian_taps_np(sigma)
        check(len(taps) == 2 * r + 1, f"sigma {sigma}: radius {len(taps) // 2} != {r}")
        tt = torch.from_numpy(taps).to("cuda")
        for name, got, ref in (
                ("hwc", G.gauss_blur(img, sigma), G.gauss_blur_reference(img, sigma)),
                ("planes", G.blur_planes(planes, tt), rl_fused.blur(planes, taps.tolist()))):
            err, _ = blur_vs_plain(torch, got, ref, f"gauss_blur {name} radius {r}")
            worst[name] = max(worst[name], err)
    emit(card, phase="gauss_blur_radii", radii=[1, G.MAX_RADIUS],
         shapes={"hwc": [75, 77, 3], "planes": [2, 75, 77]}, max_abs_err=worst)


def phase_gauss_blur(torch, card):
    from nind_denoise_tpu_torch.ops import gauss_blur as G
    from nind_denoise_tpu_torch.ops import rl_fused
    from nind_denoise_tpu_torch.ops.rl_deblur import gaussian_taps_np

    gen = torch.Generator().manual_seed(5)
    product = None
    for (h, w, sigma) in ((2000, 3000, 1.0), (2000, 3000, 3.0), (2000, 3000, 21.0),
                          (97, 131, 1.0), (5, 7, 3.0), (24, 6000, 1.0)):
        img = torch.rand(h, w, 3, generator=gen).to("cuda")
        ref = G.gauss_blur_reference(img, sigma)
        err, tol = blur_vs_plain(torch, G.gauss_blur(img, sigma), ref,
                                 f"gauss_blur {h}x{w} sigma {sigma}")
        taps = gaussian_taps_np(sigma)
        r = (len(taps) - 1) // 2
        rec = dict(phase="gauss_blur", shape=[h, w, 3], sigma=sigma, radius=r,
                   max_abs_err=err, tol=tol)
        if h == 2000:
            rec.update(blur_times(torch, lambda: G.gauss_blur(img, sigma),
                                  lambda: G.gauss_blur_reference(img, sigma),
                                  blur_library(torch, img, taps, hwc=True), ref, r, 50))
            product = product or rec
        emit(card, **rec)
    # the planar entry at 6 MP: sigma 10 (R 30, beside K1's), 11 (R 33,
    # RL's separable_k3 route) and 21.3 (R 64)
    planes = torch.rand(3, 2000, 3000, generator=gen).to("cuda")
    for sigma in (10.0, 11.0, 21.3):
        taps = gaussian_taps_np(sigma)
        r = (len(taps) - 1) // 2
        tt = torch.from_numpy(taps).to("cuda")
        out = torch.empty_like(planes)
        ref = rl_fused.blur(planes, taps.tolist())
        err, tol = blur_vs_plain(torch, G.blur_planes(planes, tt, out=out), ref,
                                 f"blur_planes radius {r}")
        emit(card, phase="blur_planes", shape=[3, 2000, 3000], sigma=sigma, radius=r,
             max_abs_err=err, tol=tol,
             **blur_times(torch, lambda: G.blur_planes(planes, tt, out=out),
                          lambda: rl_fused.blur(planes, taps.tolist()),
                          blur_library(torch, planes, taps), ref, r, 20))
    gauss_blur_radius_sweep(torch, card)
    try:
        G.gauss_blur(img, 22.0)
    except ValueError as e:
        emit(card, phase="gauss_blur", check=f"sigma 22 raises: {e}")
    else:
        fail("gauss_blur: sigma 22 (radius 66) did not raise")
    return product


def phase_end_to_end(torch, card, tmp):
    import cv2
    import numpy as np

    from nind_denoise_tpu_torch.core.tiles import TilePlan
    from nind_denoise_tpu_torch.ops import enc1 as E
    from nind_denoise_tpu_torch.ops import gauss_blur as G
    from nind_denoise_tpu_torch.ops import rl_fused as R
    from nind_denoise_tpu_torch.pipeline import denoise_cli

    rng = np.random.default_rng(3)
    tif = os.path.join(tmp, "img.tif")
    check(cv2.imwrite(tif, rng.integers(0, 65536, (2000, 3000, 3)).astype(np.uint16)),
          "could not write the TIFF")
    ckpt = os.path.join(tmp, "generator_1.npz")
    write_jax_checkpoint(ckpt, 64, seed=4)
    outdir = os.path.join(tmp, "out")
    os.makedirs(outdir)
    argv = [tif, "--tiff-input", "--model_path", ckpt, "-o", outdir,
            "--compute_dtype", "bfloat16", "--batch_size", "8"]
    denoise_cli.main(argv)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    E.launches = R.launches = G.launches = 0
    t0 = time.time()
    out = denoise_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"enc1": E.launches, "rl_iter": R.launches, "gauss_blur": G.launches}
    plan = TilePlan(2000, 3000, 504, 480, 6)
    batches = (plan.ipervl + 1) * math.ceil((plan.iperhl + 1) / 8)
    check(launches["enc1"] == batches,
          f"enc1 launched {launches['enc1']} times, expected {batches}")
    check(launches["rl_iter"] == 10,
          f"rl_iter launched {launches['rl_iter']} times, expected 10")
    img = cv2.imread(str(out))
    check(img is not None and img.shape == (2000, 3000, 3), f"bad output {out}")
    emit(card, phase="end_to_end", shape=[2000, 3000, 3], compute_dtype="bfloat16",
         wall_s=wall, mp_per_s=6.0 / wall, tile_batches=batches, launches=launches,
         output=os.path.basename(str(out)))

    # where the time goes: one more run under the profiler (not timed above)
    # (the profiler's own host cost inflates that run's wall, so the busy
    # share is taken against the unprofiled wall above)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        denoise_cli.main(argv + ["-v"])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit(card, phase="end_to_end_profile", device_ms=device_ms,
         device_busy_share=device_ms / 1e3 / wall,
         top_device_ms={e.key[:90]: e.self_device_time_total / 1e3 for e in top})

    # small image, fp32 without TF32: the card against the CPU
    small = os.path.join(tmp, "small.tif")
    cv2.imwrite(small, rng.integers(0, 65536, (150, 170, 3)).astype(np.uint16))
    seen = []
    encode = denoise_cli._encode_u8

    def spy(u8, path, quality):
        seen.append(np.array(u8))
        encode(u8, path, quality)

    denoise_cli._encode_u8 = spy
    try:
        for dev in ("cuda", "cpu"):
            denoise_cli.main([small, "--tiff-input", "--model_path", ckpt,
                              "-o", outdir, "--compute_dtype", "float32",
                              "--precision", "float32", "--cs", "104", "--ucs", "88",
                              "--device", dev])
    finally:
        denoise_cli._encode_u8 = encode
    diff = int(np.abs(seen[0].astype(int) - seen[1].astype(int)).max())
    check(diff <= 1, f"small image: card and CPU differ by {diff} LSB")
    emit(card, phase="end_to_end_small", shape=[150, 170, 3], compute_dtype="float32",
         max_lsb_diff_cuda_vs_cpu=diff)
    return launches


def record_inputs(mod, name, key):
    """Wrap ``mod.<name>`` so that, while ``rec["on"]``, the first call at
    each ``key(*args)`` (None: skip) keeps a copy of its tensor arguments
    in ``rec["seen"]``. The wrapped function still runs, and counts its
    launch, once per call. ``rec["restore"]()`` puts it back."""
    fn = getattr(mod, name)
    rec = {"on": True, "seen": {}}

    def spy(*args, **kw):
        k = key(*args) if rec["on"] else None
        if k is not None and k not in rec["seen"]:
            rec["seen"][k] = [a.detach().clone() for a in args]
        return fn(*args, **kw)

    setattr(mod, name, spy)
    rec["restore"] = lambda: setattr(mod, name, fn)
    return rec


def phase_serve(torch, card, tmp, kernel_mods):
    """The serving daemon in process on the card. Returns the launch counts
    of its HTTP traffic, summed over the windows it was driven in; the K2
    and K1 inputs that traffic gave the kernels, one per shape; and the
    served model."""
    import threading
    import urllib.request

    import cv2
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nind_denoise_tpu_torch.ops import rl_deblur as RL
    from nind_denoise_tpu_torch.pipeline import serve as S

    ckpt1 = os.path.join(tmp, "generator_1.npz")  # phase_end_to_end's weights
    ckpt2 = os.path.join(tmp, "generator_2.npz")
    write_jax_checkpoint(ckpt2, 64, seed=7)
    svc = S.DenoiseService("UtNet", ckpt1, cs=504, ucs=480, batch_size=8,
                           compute_dtype="bfloat16")
    httpd = S.serve(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    total = {name: 0 for name in kernel_mods}
    recs = {
        "enc1": record_inputs(kernel_mods["enc1"], "enc1",
                              lambda x, *w: (tuple(x.shape), str(x.dtype))),
        # the first iteration of each RL run, where u is d
        "rl_iter": record_inputs(kernel_mods["rl_iter"], "rl_iter",
                                 lambda u, d, taps: tuple(d.shape) if u is d else None)}

    def drive(fn):
        """Run HTTP traffic with every kernel count set to 0 just before
        and read just after; returns (result, counts of this window)."""
        for m in kernel_mods.values():
            m.launches = 0
        out = fn()
        torch.cuda.synchronize()
        seen = {name: m.launches for name, m in kernel_mods.items()}
        for name in total:
            total[name] += seen[name]
        return out, seen

    def png(img):
        ok, buf = cv2.imencode(".png", img[..., ::-1])
        check(ok, "PNG encode failed")
        return buf.tobytes()

    def post(data, query):
        req = urllib.request.Request(f"{base}/denoise?{query}", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            check(r.status == 200, f"status {r.status}")
            return r.read()

    def decode(body):
        return cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_UNCHANGED)[..., ::-1]

    def direct(raw, sigma=1.0, iterations=10):
        out = svc._adaptive.denoise_raw(raw, 65535.0, out_dtype="device")
        return RL.rl_to_u8_device(out, sigma, iterations).cpu().numpy()

    def stats():
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            return json.loads(r.read())

    rng = np.random.default_rng(8)
    rl_q = "output=png&rl=1&sigma=1&iterations=10"

    try:
        # 1. 6 MP requests, one cold then five warm, equal to the direct run
        big = png(rng.integers(0, 65536, (2000, 3000, 3), dtype=np.uint16))
        t0 = time.time()
        drive(lambda: post(big, rl_q))
        cold = time.time() - t0
        warm, bodies = [], []
        for _ in range(5):
            t0 = time.time()
            body, seen = drive(lambda: post(big, rl_q))
            warm.append(time.time() - t0)
            bodies.append(body)
            check(seen["enc1"] == 5 and seen["rl_iter"] == 10,
                  f"serve 6 MP: launches {seen}")
        check(all(b == bodies[0] for b in bodies), "serve 6 MP: responses differ")
        check(np.array_equal(decode(bodies[0]), direct(decode(big))),
              "serve 6 MP: response differs from the direct engine + RL run")
        emit(card, phase="serve", case="6MP png rl=1", shape=[2000, 3000, 3],
             latency_s_cold=cold, latency_s=warm,
             latency_s_p50=float(np.median(warm)), launches=seen,
             equal_to_direct_run=True)

        # 2. 480 x 480 requests: serial, then eight queued at once behind
        # the parked dispatcher (one group), then free-running bursts of
        # eight. Prewarm's zero images are not kept as kernel inputs.
        smalls = [png(rng.integers(0, 65536, (480, 480, 3), dtype=np.uint16))
                  for _ in range(8)]
        serial, seen = drive(lambda: [post(d, rl_q) for d in smalls])
        check(seen["enc1"] == 8 and seen["rl_iter"] == 80,
              f"serve serial: launches {seen}")
        for r in recs.values():
            r["on"] = False
        warm_info = svc.prewarm(480, 480)
        for r in recs.values():
            r["on"] = True

        def burst(park):
            bodies, lat = [None] * 8, [0.0] * 8
            release = threading.Event()
            if park:
                gate = threading.Event()
                blocker = threading.Thread(
                    target=lambda: svc.submit(lambda: gate.set() or release.wait(120)))
                blocker.start()
                check(gate.wait(60), "dispatcher did not park")

            def hit(i):
                t = time.time()
                bodies[i] = post(smalls[i], rl_q)
                lat[i] = time.time() - t

            threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            if park:
                deadline = time.time() + 60
                while svc._q.qsize() < 8 and time.time() < deadline:
                    time.sleep(0.01)
                check(svc._q.qsize() == 8, "the eight requests did not queue")
                release.set()
                blocker.join(60)
            for t in threads:
                t.join(300)
                check(not t.is_alive(), "a request hung")
            return bodies, lat

        def vs_serial(bodies):
            """Coalesced responses against their serial ones: cuDNN may
            round a tile differently in another batch, so hold them to
            1 LSB and count what differs."""
            d = [np.abs(decode(b).astype(int) - decode(s).astype(int))
                 for b, s in zip(bodies, serial)]
            out = {"max_lsb": int(max(x.max() for x in d)),
                   "values_differing": int(sum((x > 0).sum() for x in d)),
                   "responses_identical": sum(b == s for b, s in zip(bodies, serial))}
            check(out["max_lsb"] <= 1, f"a coalesced response is off its serial one: {out}")
            return out

        before = stats()
        (bodies, _), seen = drive(lambda: burst(park=True))
        after = stats()
        check(after["coalesced_requests"] - before["coalesced_requests"] == 8,
              "the parked burst did not coalesce into one group")
        check(seen["enc1"] == 1 and seen["rl_iter"] == 10,
              f"serve coalesced group of 8: launches {seen}, expected 1 and 10")
        # the same group straight through the engine: the fp32 canvases of
        # the coalesced run against each image's own run, held to one bf16
        # ulp at the canvases' largest magnitude
        raws = [decode(d) for d in smalls]
        many = svc._adaptive.denoise_many(raws, 65535.0, out_dtype="device")
        alone = [svc._adaptive.denoise_raw(r, 65535.0, out_dtype="device") for r in raws]
        eng_diff = max((m - a).abs().max().item() for m, a in zip(many, alone))
        eng_tol = bf16_ulp(max(a.abs().max().item() for a in alone))
        check(eng_diff <= eng_tol,
              f"coalesced canvases off their own runs by {eng_diff} > {eng_tol}")
        emit(card, phase="serve", case="group of 8 at 480x480, coalesced vs serial",
             launches=seen, responses=vs_serial(bodies),
             engine_slots_equal=[bool(torch.equal(m, a)) for m, a in zip(many, alone)],
             engine_max_abs_diff=eng_diff, engine_tol=eng_tol)

        def bursts(rounds, label):
            before = stats()
            t0 = time.time()
            runs, seen = drive(lambda: [burst(park=False) for _ in range(rounds)])
            wall = time.time() - t0
            diffs = [vs_serial(b) for b, _ in runs]
            after = stats()
            groups = {k: v - before["group_sizes"].get(k, 0)
                      for k, v in after["group_sizes"].items()
                      if v != before["group_sizes"].get(k, 0)}
            n_groups = sum(groups.values())
            # each group of <= 8 one-tile images is one tile batch and one RL run
            check(seen["enc1"] == n_groups and seen["rl_iter"] == 10 * n_groups,
                  f"serve bursts: launches {seen} for {n_groups} groups {groups}")
            lats = [x for _, lat in runs for x in lat]
            n_req = 8 * rounds
            rec = dict(phase="serve", case=f"480x480 png rl=1, {rounds} bursts of 8{label}",
                       requests=n_req, wall_s=wall, req_per_s=n_req / wall,
                       mp_per_s=n_req * 480 * 480 / 1e6 / wall,
                       client_latency_ms_p50=float(np.percentile(lats, 50)) * 1e3,
                       client_latency_ms_p95=float(np.percentile(lats, 95)) * 1e3,
                       group_sizes=groups,
                       coalesced_requests=after["coalesced_requests"]
                       - before["coalesced_requests"], launches=seen,
                       vs_serial={"max_lsb": max(d["max_lsb"] for d in diffs),
                                  "values_differing": sum(d["values_differing"]
                                                          for d in diffs),
                                  "responses_identical": sum(d["responses_identical"]
                                                             for d in diffs)},
                       stage_s={k: after["stage_s"][k] - before["stage_s"][k]
                                for k in after["stage_s"]})
            return rec, after

        # a window of some seconds, then a shorter one under the profiler
        # for the device's share (the profiler's host cost inflates that
        # window's wall, so the busy share is taken against the unprofiled
        # window's wall per request)
        rec, after = bursts(40, "")
        emit(card, **rec, server_latency_ms=after["latency_ms"], prewarm=warm_info)
        check(after["coalesced_requests"] >= 2, "no request was coalesced")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_rec, _ = bursts(8, " under the profiler")
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        emit(card, phase="serve_profile", requests=prof_rec["requests"],
             wall_s_profiled=prof_rec["wall_s"], group_sizes=prof_rec["group_sizes"],
             device_ms=device_ms, device_ms_per_request=device_ms / prof_rec["requests"],
             device_busy_share=device_ms / 1e3 / prof_rec["requests"] * rec["req_per_s"],
             top_device_ms={e.key[:90]: e.self_device_time_total / 1e3 for e in top})

        # 3. an adapted tiling (64 x 64 -> cs 136) and the tiny-image path
        for hw in ((64, 64), (40, 44)):
            raw = rng.integers(0, 65536, (*hw, 3), dtype=np.uint16)
            body, seen = drive(lambda: post(png(raw), rl_q))
            check(np.array_equal(decode(body), direct(raw)), f"serve {hw}: differs")
            emit(card, phase="serve", case=f"{hw[0]}x{hw[1]}", launches=seen,
                 engines=sorted(str(k) for k in svc._adaptive._engines))
        check("tiny" in svc._adaptive._engines, "the tiny-image path was not taken")

        # 4. reload to the second checkpoint: the next response runs on it
        req = urllib.request.Request(f"{base}/reload?model_path={ckpt2}", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            check(json.loads(r.read())["status"] == "reloaded", "reload failed")
        body, _ = drive(lambda: post(smalls[0], rl_q))
        got = decode(body)
        check(not np.array_equal(got, decode(serial[0])), "reload did not swap the weights")
        check(np.array_equal(got, direct(decode(smalls[0]))),
              "after reload: response differs from the direct run on the new weights")
        emit(card, phase="serve", case="reload", reloads=stats()["reloads"],
             equal_to_direct_run=True)
    finally:
        for r in recs.values():
            r["restore"]()

    model = svc._adaptive._resolved
    httpd.shutdown()
    httpd.server_close()
    svc.close()
    svc._worker.join(30)
    check(not svc._worker.is_alive(), "the dispatcher did not stop")
    return total, {k: r["seen"] for k, r in recs.items()}, model


def phase_serve_kernels(torch, card, inputs, model):
    """K2 and K1 against their plain versions on the inputs the serve
    traffic gave them, one per shape: among them the coalesced groups'
    stacked RL planes and the adapted and tiny-image tiles. Then the
    witness behind the 1 LSB limit on coalesced responses: one tile in all
    eight slots of a batch, against the same tile alone (a serial
    request's batch of 1). K2 must give every slot the bits of the tile
    alone; cuDNN's first level-2 convolution and the whole forward are
    reported slot by slot."""
    from nind_denoise_tpu_torch.ops import enc1 as E
    from nind_denoise_tpu_torch.ops import rl_fused as R

    checked = {"enc1": [], "rl_iter": []}
    with torch.inference_mode():
        for (shape, dtype), args in inputs["enc1"].items():
            err, tol = enc1_vs_plain(torch, E, args)
            check(err <= tol, f"serve enc1 {shape} {dtype}: max err {err} > {tol}")
            checked["enc1"].append({"shape": list(shape), "dtype": dtype,
                                    "max_abs_err": err, "tol": tol})
        for shape, (_, d, taps) in inputs["rl_iter"].items():
            err, tol = rl_vs_plain(torch, R, d, taps, 10)
            check(err <= tol, f"serve rl_iter {shape}: max err {err} > {tol}")
            checked["rl_iter"].append({"shape": list(shape), "iterations": 10,
                                       "max_abs_err": err, "tol": tol})
    for kernel, shape in (("enc1", (8, 3, 508, 508)), ("enc1", (1, 3, 140, 140)),
                          ("rl_iter", (24, 480, 480))):
        check(any(c["shape"] == list(shape) for c in checked[kernel]),
              f"the serve traffic gave {kernel} no input of shape {shape}")
    emit(card, phase="serve_kernel_shapes", **checked)

    gen = torch.Generator().manual_seed(9)
    tile = torch.rand(1, 3, 504, 504, generator=gen).to("cuda", torch.bfloat16)
    batch = tile.repeat(8, 1, 1, 1)
    with torch.inference_mode():
        l1_1, l2_1 = model.encode1(tile)
        l1_8, l2_8 = model.encode1(batch)
        conv = model.convs2[0]
        c_1, c_8 = conv(l2_1), conv(l2_8)
        f_1, f_8 = model(tile), model(batch)
        torch.cuda.synchronize()

    def by_slot(y8, y1):
        return {"max_abs_diff_vs_batch_of_1": [(y8[k].float() - y1[0].float())
                                               .abs().max().item() for k in range(8)],
                "slots_equal_slot_0": all(torch.equal(y8[k], y8[0]) for k in range(8))}

    enc1_equal = all(torch.equal(l1_8[k], l1_1[0]) and torch.equal(l2_8[k], l2_1[0])
                     for k in range(8))
    check(enc1_equal, "enc1 gives a tile different bits in a batch of 8")
    emit(card, phase="serve_batch_witness", tile=[504, 504], dtype="bfloat16",
         enc1_slots_equal_batch_of_1=enc1_equal,
         cudnn_conv=by_slot(c_8, c_1), forward=by_slot(f_8, f_1))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, ROOT)
    try:
        from nind_denoise_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port is not next to this script: {e}")
    card = card_line()

    t0 = time.time()
    _build.build_all()
    emit(card, phase="build", seconds=time.time() - t0, sources=_build.sources())

    from nind_denoise_tpu_torch.ops import enc1, gauss_blur, rl_fused

    kernel_mods = {"enc1": enc1, "rl_iter": rl_fused, "gauss_blur": gauss_blur}
    enc1_rec = phase_enc1(torch, card)
    rl_rec = phase_rl(torch, card)
    blur_rec = phase_gauss_blur(torch, card)
    with tempfile.TemporaryDirectory() as tmp:
        by_path = {"denoise_cli": phase_end_to_end(torch, card, tmp)}
        by_path["serve"], serve_inputs, model = phase_serve(torch, card, tmp, kernel_mods)
    phase_serve_kernels(torch, card, serve_inputs, model)

    def row(name, source, replaces, rec):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {k: p[name] for k, p in by_path.items()},
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "ms_over_bound": rec["ms"] / rec["bound_ms"],
                "library_ms": rec.get("library_ms")}

    print(json.dumps({"kernels": [
        row("enc1", "nind_denoise_tpu_torch/csrc/enc1.cu",
            "nind_denoise_tpu/ops/pallas_enc1.py:262", enc1_rec),
        row("rl_iter", "nind_denoise_tpu_torch/csrc/rl_iter.cu",
            "nind_denoise_tpu/ops/pallas_blur.py:621", rl_rec),
        row("gauss_blur", "nind_denoise_tpu_torch/csrc/gauss_blur.cu",
            "nind_denoise_tpu/ops/pallas_blur.py:217", blur_rec),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
