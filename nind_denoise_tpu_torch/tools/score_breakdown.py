"""Where the crop audit's and ``denoise_dir``'s host and card time goes.

    python -m nind_denoise_tpu_torch.tools.score_breakdown

On seeded data: one MS-SSIM score of a 256 x 256 crop pair (the audit's
unit) timed by CUDA events and by the host clock, with its kernel count,
device time and top kernels from the profiler; the three losses of a 6 MP
pair (``denoise_dir``'s score) and the upload of one 6 MP float32 image;
the 16-bit PNG codecs at 6 MP (write, read, ``imgio.load_img``) for a
noisy and a smooth image; and the audit (``list_content_quality``) over
480 seeded crop pairs with 1, 2, 4 and 8 decode threads. One JSON line per
measurement, each with the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import tempfile
import time

import cv2
import numpy as np
import torch

from ..core import imgio
from ..eval import score
from ..train import dataset as ds_mod
from .train_breakdown import time_ms


def profiled(fn, calls: int):
    """(device ms, kernels and copies, top kernels by ms), each per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    work = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in work:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.self_device_time_total / 1e3 / calls
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return sum(by_name.values()), len(work) / calls, top


def host_ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def smooth(rng, h, w):
    low = rng.random((h // 16, w // 16, 3), np.float32)
    return np.clip(cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC), 0, 1)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("score_breakdown measures the card: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]

    def emit(**rec):
        print(json.dumps({**rec, "card": card}), flush=True)

    rng = np.random.default_rng(0)
    a = smooth(rng, 256, 256).transpose(2, 0, 1)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape, np.float32), 0, 1)
    pair = [score.to_device(x) for x in (a, b)]
    device_ms, ops, top = profiled(lambda: score.msssim(*pair), 10)
    emit(what="msssim_256", event_ms=time_ms(lambda: score.msssim(*pair), 50),
         host_ms=host_ms(lambda: score.msssim(*pair), 50), device_ms=device_ms,
         device_ops=ops, top_device_ms=top)

    a6 = smooth(rng, 2000, 3000).transpose(2, 0, 1)
    b6 = np.clip(a6 + 0.05 * rng.standard_normal(a6.shape, np.float32), 0, 1)
    pair6 = [score.to_device(x) for x in (a6, b6)]
    device_ms, ops, top = profiled(lambda: score.losses(*pair6), 3)
    emit(what="losses_6mp", event_ms=time_ms(lambda: score.losses(*pair6), 5),
         device_ms=device_ms, device_ops=ops, top_device_ms=top,
         upload_f32_host_ms=host_ms(lambda: score.to_device(b6), 5))

    with tempfile.TemporaryDirectory() as tmp:
        for name, img in (("noisy", b6), ("smooth", a6)):
            u16 = (img.transpose(1, 2, 0) * 65535).astype(np.uint16)
            path = os.path.join(tmp, f"{name}.png")
            t0 = time.perf_counter()
            cv2.imwrite(path, u16)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cv2.imread(path, cv2.IMREAD_UNCHANGED)
            read_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            imgio.load_img(path)
            emit(what="png16_6mp", image=name, write_s=write_s, read_s=read_s,
                 load_img_s=time.perf_counter() - t0, mb=os.path.getsize(path) / 1e6)

        # 2 sets x 80 crops x (ISO100, three noisy ISOs): 480 pairs
        root = os.path.join(tmp, "DS_256_192")
        scene = smooth(rng, 256, 336)
        for s in range(2):
            for iso, sigma in (("ISO100", 0), ("ISO800", 0.02), ("ISO3200", 0.05),
                               ("ISO6400", 0.08)):
                d = os.path.join(root, f"S{s}", iso)
                os.makedirs(d)
                for k in range(80):
                    crop = scene[:, k:k + 256] + sigma * rng.standard_normal(
                        (256, 256, 3), np.float32)
                    cv2.imwrite(os.path.join(d, f"NIND_S{s}_{iso}_{k}_0_192.png"),
                                (np.clip(crop, 0, 1) * 65535).astype(np.uint16))
        ds = ds_mod.DenoisingDataset([root], cs=None)
        default = ds_mod.AUDIT_DECODE_THREADS
        try:
            for threads in (1, 2, 4, 8):
                ds_mod.AUDIT_DECODE_THREADS = threads
                rates = []
                for _ in range(2):  # the first round warms the page cache
                    t0 = time.time()
                    with contextlib.redirect_stdout(io.StringIO()):  # a line a pair
                        rows = ds.list_content_quality()
                    rates.append(len(rows) / (time.time() - t0))
                emit(what="audit", decode_threads=threads, pairs=len(rows),
                     pairs_per_s=rates[-1], first_round_pairs_per_s=rates[0])
        finally:
            ds_mod.AUDIT_DECODE_THREADS = default
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
