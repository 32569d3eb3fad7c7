"""Where K2's time goes: the bf16 kernel of ``csrc/enc1.cu`` with one or
more of its phases cut out, timed against the whole kernel on the card.

    python -m nind_denoise_tpu_torch.tools.enc1_breakdown [--batch 8 --size 504]

Each variant is the kernel's source with a loop bound set to 0 (c0, c1, the
l1 stores, the l2_in stores), built by nvcc beside the kernels; the timings
are raw launches (no wrapper), warm, from CUDA events, interleaved over two
rounds. A variant's outputs are wrong by design: only its time is read.
The whole kernel's time minus a variant's is what that phase adds on top
of the rest, not the phase's own time: phases of the two tile groups of a
CTA, and of all CTAs, overlap. The plain write of the same bytes
(``fill_``) gives the card's write rate for comparison. One JSON line per
variant, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess

import torch

from ..ops import _build
from ..ops import enc1 as E

_C0 = "\n    for (int mt = warp; mt < C0_MT; mt += GWARPS) {"
_C1 = "\n    for (int tap = 0; tap < 9; ++tap) {"
_L1 = "\n    for (int i = gtid; i < C * T * 2; i += GT) {"
_L2 = "\n    for (int i = gtid; i < C * (T / 2) * 2; i += GT) {"
_CUT = {
    _C0: ("mt < C0_MT", "mt < 0"),
    _C1: ("tap < 9", "tap < 0"),
    _L1: ("i < C * T * 2", "i < 0"),
    _L2: ("i < C * (T / 2) * 2", "i < 0"),
}
VARIANTS = {
    "whole": (),
    "no_c0": (_C0,),
    "no_c1": (_C1,),
    "no_l1_store": (_L1,),
    "no_l2_store": (_L2,),
    "no_stores": (_L1, _L2),
    "no_c1_no_stores": (_C1, _L1, _L2),
    "no_c0_c1_stores": (_C0, _C1, _L1, _L2),
}


def variant_source(src: str, cuts) -> str:
    for line in cuts:
        if src.count(line) != 1:
            raise RuntimeError(f"enc1.cu no longer has the loop {line.strip()!r} once")
        old, new = _CUT[line]
        src = src.replace(line, line.replace(old, new))
    return src


def build(names):
    """{name: ctypes library} for each variant, one nvcc each, in parallel."""
    out = _build.BUILD_DIR / "enc1_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "enc1.cu").read_text()
    procs = {}
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(src, VARIANTS[name]))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.enc1_bf16_launch.argtypes = E._SIG["enc1_bf16_launch"]
        lib.enc1_bf16_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=504)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("enc1_breakdown: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    libs = build(VARIANTS)
    bsz, h = args.batch, args.size
    gen = torch.Generator().manual_seed(1)
    dt = torch.bfloat16

    def u(*shape, fan_in):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) / math.sqrt(fan_in)).to("cuda", dt)

    x = torch.rand(bsz, 3, h + 4, h + 4, generator=gen).to("cuda", dt)
    w0, b0, w1, b1 = u(64, 3, 3, 3, fan_in=27), u(64, fan_in=27), u(64, 64, 3, 3, fan_in=576), \
        u(64, fan_in=576)
    a = torch.full((1,), 0.25, device="cuda", dtype=dt)
    w1p = E.pack_w1(w1)
    l1 = torch.empty(bsz, 64, h, h, device="cuda", dtype=dt)
    l2 = torch.empty(bsz, 64, h // 2, h // 2, device="cuda", dtype=dt)
    ty, tx = E.tile_grid(h, h)
    ctas = E.cta_count(bsz * ty * tx, torch.cuda.get_device_properties(0).multi_processor_count)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name):
        err = libs[name].enc1_bf16_launch(
            x.data_ptr(), w0.data_ptr(), w1p.data_ptr(), b0.data_ptr(), b1.data_ptr(),
            a.data_ptr(), a.data_ptr(), l1.data_ptr(), l2.data_ptr(), bsz, h, h, ty, tx, ctas,
            stream)
        _build.check(err, f"enc1 {name}")

    times = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            times[name].append(time_ms(lambda: run(name)))
    out_bytes = (l1.numel() + l2.numel()) * 2
    fill = torch.empty(l1.numel() + l2.numel(), device="cuda", dtype=dt)
    write_ms = time_ms(lambda: fill.fill_(0))
    whole = sum(times["whole"]) / 2
    for name, t in times.items():
        ms = sum(t) / 2
        print(json.dumps({"kernel": "enc1_bf16", "variant": name, "shape": [bsz, h, h],
                          "ms": ms, "ms_rounds": t, "whole_minus_variant_ms": whole - ms,
                          "card": card}))
    print(json.dumps({"kernel": "fill_", "bytes": out_bytes, "ms": write_ms,
                      "tb_per_s": out_bytes / write_ms / 1e9, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
