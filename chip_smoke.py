#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nind_denoise_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (every line carries the card's name and power
limit as nvidia-smi reports them):

1. build every kernel in ``nind_denoise_tpu_torch/csrc`` (one nvcc each,
   all at once);
2. K2 (enc1) against its plain PyTorch version on the card, at the product
   batch (8 x 504 x 504, funit 64) in bf16 and fp32, and at 104 x 136;
3. K1 (one RL iteration) against a loop of its plain version, at
   2000 x 3000 x 3, sigma 1, 10 iterations, plus the short-tail heights,
   sigma 3, a 6000-wide strip and a batch of 3 that must equal its single
   runs bit for bit;
4. end to end: a seeded 16-bit 2000 x 3000 TIFF and a seeded funit-64 .npz
   checkpoint through ``denoise_cli --tiff-input`` in bf16 to a JPEG,
   with the kernel launch counts of that run; then a small image in fp32
   on the card and on the CPU, whose pre-encode uint8 images must agree to
   1 LSB.

Then a ``kernels`` line (per-launch times against each kernel's bound),
the card line and, last, ``{"ok": true, "device": {...}}``. Any failure,
a missing GPU or a failed build exits non-zero without that last line.
Times are warm, from CUDA events.
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


def phase_enc1(torch, card):
    from nind_denoise_tpu_torch.ops import enc1 as E

    gen = torch.Generator().manual_seed(1)
    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for bsz, h, w in ((8, 504, 504), (2, 104, 136)):
            x = torch.rand(bsz, 3, h + 4, w + 4, generator=gen).to("cuda", dt)

            def u(*shape, fan_in):
                b = 1.0 / math.sqrt(fan_in)
                return ((torch.rand(*shape, generator=gen) * 2 - 1) * b).to("cuda", dt)

            args = (x, u(64, 3, 3, 3, fan_in=27), u(64, fan_in=27),
                    torch.full((1,), 0.25, device="cuda", dtype=dt),
                    u(64, 64, 3, 3, fan_in=576), u(64, fan_in=576),
                    torch.full((1,), 0.25, device="cuda", dtype=dt))
            # fp32 reference in full fp32: no TF32 in cuDNN
            torch.backends.cudnn.allow_tf32 = False
            l1, l2 = E.enc1(*args)
            r1, r2 = E.enc1_reference(*args)
            torch.cuda.synchronize()
            err = max((l1.float() - r1.float()).abs().max().item(),
                      (l2.float() - r2.float()).abs().max().item())
            scale = max(1.0, r1.float().abs().max().item())
            # fp32: only the order of the 27- and 576-term sums differs.
            # bf16: t0 and l1 are rounded to 8 mantissa bits; a sum-order
            # change can flip a t0 rounding, moving l1 by a few ulps, so
            # allow 4 bf16 ulps at the output's magnitude (4 * 2^-8).
            tol = (1e-4 if dtype == "float32" else 4 * 2 ** -8) * scale
            check(err <= tol, f"enc1 {dtype} {bsz}x{h}x{w}: max err {err} > {tol}")
            item = 2 if dt == torch.bfloat16 else 4
            nbytes = item * (x.numel() + 64 * 27 + 64 * 576 + 130
                             + l1.numel() + l2.numel())
            flops = 2.0 * bsz * h * w * 64 * 576 + 2.0 * bsz * (h + 2) * (w + 2) * 64 * 27
            bms, by = bound_ms(nbytes, flops, dtype)
            reps = 10 if h == 504 else 50
            ms = time_ms(torch, lambda: E.enc1(*args), reps)
            plain = time_ms(torch, lambda: E.enc1_reference(*args), reps)
            rec = dict(phase="enc1", dtype=dtype, shape=[bsz, h, w], max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
            emit(card, **rec)
            out[(dtype, h)] = rec
    torch.backends.cudnn.allow_tf32 = True
    return out[("bfloat16", 504)]


def phase_rl(torch, card):
    from nind_denoise_tpu_torch.ops import rl_deblur as RL
    from nind_denoise_tpu_torch.ops import rl_fused as R

    gen = torch.Generator().manual_seed(2)
    tol = 2e-5  # fp32, as the CPU tests; the kernel rounds like the plain version
    product = None
    for (h, w, sigma, iters) in ((2000, 3000, 1.0, 10), (361, 140, 1.0, 10),
                                 (362, 140, 1.0, 10), (130, 260, 3.0, 10),
                                 (24, 6000, 1.0, 10)):
        img = (torch.rand(h, w, 3, generator=gen) + 0.05).to("cuda")
        got = RL.rl_deblur(img, sigma, iters)
        taps = RL.gaussian_taps_np(sigma)
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
        rec = dict(phase="rl_iter", shape=[h, w, 3], sigma=sigma,
                   iterations=iters, max_abs_err=err, tol=tol)
        if product is None:
            tt = torch.from_numpy(taps).to("cuda")
            out = torch.empty_like(d)
            nbytes = 3 * d.numel() * 4 + tt.numel() * 4
            r = (len(taps) - 1) // 2
            # two separable blurs (2 passes of 2r+1 mul+add), the ratio's
            # max and divide, the final multiply
            flops = d.numel() * (2 * 2 * 2 * (2 * r + 1) + 3)
            bms, by = bound_ms(nbytes, flops, "float32")
            rec.update(
                ms=time_ms(torch, lambda: R.rl_iter(d, d, tt, out=out), 20),
                plain_ms=time_ms(torch, lambda: R.rl_iter_reference(d, d, taps), 5),
                bound_ms=bms, bound_by=by)
            product = rec
        emit(card, **rec)
    batch = (torch.rand(3, 120, 176, 3, generator=gen) + 0.05).to("cuda")
    together = RL.rl_deblur(batch, 1.0, 10)
    for i in range(3):
        check(torch.equal(together[i], RL.rl_deblur(batch[i], 1.0, 10)),
              f"rl batch member {i} differs from its single run")
    emit(card, phase="rl_iter", check="batch of 3 equals its single runs bit for bit")
    return product


def phase_end_to_end(torch, card, tmp):
    import cv2
    import numpy as np

    from nind_denoise_tpu_torch.core.tiles import TilePlan
    from nind_denoise_tpu_torch.ops import enc1 as E
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
    E.launches = R.launches = 0
    t0 = time.time()
    out = denoise_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"enc1": E.launches, "rl_iter": R.launches}
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

    enc1_rec = phase_enc1(torch, card)
    rl_rec = phase_rl(torch, card)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_end_to_end(torch, card, tmp)

    def row(name, source, replaces, rec):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None}

    print(json.dumps({"kernels": [
        row("enc1", "nind_denoise_tpu_torch/csrc/enc1.cu",
            "nind_denoise_tpu/ops/pallas_enc1.py:262", enc1_rec),
        row("rl_iter", "nind_denoise_tpu_torch/csrc/rl_iter.cu",
            "nind_denoise_tpu/ops/pallas_blur.py:621", rl_rec),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
