"""Where K2's time goes: one instance of ``csrc/enc1.cu`` (bf16 or fp32)
with one or more of its phases cut out, timed against the whole kernel on
the card, and for fp32 the parent kernel beside it.

    python -m nind_denoise_tpu_torch.tools.enc1_breakdown [--dtype bfloat16|float32]
        [--batch B --size S] [--parent PATH]

Each variant is the kernel's source with a loop bound set to 0 (c0, c1, the
l1 stores, the l2_in stores), built by nvcc (``-Xptxas -v``) beside the
kernels; the timings are raw launches (no wrapper), warm, from CUDA events,
interleaved over two rounds, at B x S x S outputs (default 8 x 504 for
bf16, 30 x 184 for fp32). A variant's outputs are wrong by design: only its
time is read (with both stores cut nothing reads c1's sums, and nvcc drops
c1 as well). The whole kernel's time minus a variant's is what that phase
adds on top of the rest, not the phase's own time: phases of the tiles in
flight on an SM, and of all SMs, overlap. The plain write of the same bytes
(``fill_``) gives the card's write rate for comparison. For fp32, design
variants each undo one choice of the shipped kernel (``DESIGN``) and are
held bit-equal to it: c1's loads ahead of each input channel guarded by a
branch, every warp running c0 before c1, and c1's channel loop unrolled by
2.

fp32 only: at every shape the port gives the fp32 instance (the trainer's
validation crop, the cGAN's and a data-parallel rank's learn, the sharded
test's two bands, the fp32 CLI's batch) and at ragged ones, the kernel
alone (raw launch) and through the wrapper (``ops/enc1.enc1``, which also
lays out w1 and the biases on every call), against the bound and against
the plain version (``enc1_reference``, fp32 without TF32). ``--parent``
takes an earlier tree's ``enc1.cu`` (``git show <commit>:<path> >
build/parent_enc1.cu``) with the one-CTA-a-tile fp32 entry: it is timed in
the same rounds, and the largest difference between its l1 and l2_in and
the shipped kernel's is reported at every shape (0 when the operation
sequence is the same). One JSON line per row, each with the card's name and
power limit; first the registers and spills ptxas gave each build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops import enc1 as E

# loop headers of each instance: (line, (old, new)) sets the bound to 0
_CUTS = {
    "bfloat16": {
        "c0": ("\n    for (int mt = warp; mt < C0_MT; mt += GWARPS) {", ("mt < C0_MT", "mt < 0")),
        "c1": ("\n    for (int tap = 0; tap < 9; ++tap) {", ("tap < 9", "tap < 0")),
        "l1": ("\n    for (int i = gtid; i < C * T * 2; i += GT) {", ("i < C * T * 2", "i < 0")),
        "l2": ("\n    for (int i = gtid; i < C * (T / 2) * 2; i += GT) {",
               ("i < C * (T / 2) * 2", "i < 0")),
    },
    "float32": {
        "c0": ("\n  for (int round = 0; round < C0_ROUNDS; ++round) {",
               ("round < C0_ROUNDS", "round < 0")),
        "c1": ("\n  for (int ci = 0; ci < CC; ++ci) {", ("ci < CC", "ci < 0")),
        "l1": ("\n  for (int kl = 0; kl < 8; ++kl) {", ("kl < 8", "kl < 0")),
        "l2": ("\n  for (int kp = 0; kp < 8; ++kp) {", ("kp < 8", "kp < 0")),
    },
}
VARIANTS = {
    "whole": (),
    "no_c0": ("c0",),
    "no_c1": ("c1",),
    "no_l1_store": ("l1",),
    "no_l2_store": ("l2",),
    "no_stores": ("l1", "l2"),
    "no_c1_no_stores": ("c1", "l1", "l2"),
    "no_c0_c1_stores": ("c0", "c1", "l1", "l2"),
}
# fp32 design variants: (old, new) substitutions that undo one choice
_C1_WIN = "      nu[r] = *reinterpret_cast<const float4*>(tn + r * T0S);"
_C1_WIN2 = "      nv[r] = *reinterpret_cast<const float2*>(tn + r * T0S + 4);"
_CI_LOOP = "#pragma unroll 1\n  for (int ci = 0; ci < CC; ++ci) {"
DESIGN = {
    "guarded_loads_ahead": ((_C1_WIN, _C1_WIN.replace("nu[r] =", "if (ci + 1 < CC) nu[r] =")),
                            (_C1_WIN2, _C1_WIN2.replace("nv[r] =", "if (ci + 1 < CC) nv[r] ="))),
    "c0_first_everywhere": (("const bool c0_first = warp < 4;", "const bool c0_first = true;"),),
    "unroll_2": ((_CI_LOOP, _CI_LOOP.replace("unroll 1", "unroll 2")),),
}
KERNEL = {"bfloat16": "enc1_bf16_kernel", "float32": "enc1_f32_kernel"}
# the fp32 instance's shapes on the port's paths (outputs B, H, W), then
# ragged ones (partial tiles, W % 4 == 2, one 2 x 2 image)
F32_SHAPES = ((30, 184, 184), (15, 184, 184), (1, 184, 184), (1, 1208, 3000),
              (1, 1192, 3000), (8, 504, 504))
F32_RAGGED = ((1, 2, 2), (3, 50, 30), (2, 20, 70), (1, 40, 98), (2, 36, 20), (1, 20, 24))
PARENT_ENTRY = "void* l1, void* l2, int B, int H, int W, void* stream) {"
PARENT_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def variant_source(src: str, dtype: str, cuts) -> str:
    for cut in cuts:
        line, (old, new) = _CUTS[dtype][cut]
        if src.count(line) != 1:
            raise RuntimeError(f"enc1.cu no longer has the loop {line.strip()!r} once")
        src = src.replace(line, line.replace(old, new))
    return src


def design_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"enc1.cu no longer has {old!r} once")
        src = src.replace(old, new)
    return src


def parent_source(src: str) -> str:
    """An earlier ``enc1.cu``, checked to have the one-CTA-a-tile fp32
    entry (no tile grid or CTA count)."""
    if src.count(PARENT_ENTRY) != 1:
        raise RuntimeError("the parent source lacks the first port's enc1_f32_launch")
    return src


def build(sources):
    """{name: (ctypes library, ptxas log)} for {name: source text}, one
    nvcc each, all at once, beside the shipped library's own build."""
    out = _build.BUILD_DIR / "enc1_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    shipped = _build._start("enc1")
    procs = {}
    for name, src in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o", str(out / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, sig in E._SIG.items():
            getattr(lib, fn).argtypes = PARENT_SIG if (name, fn) == (
                "parent", "enc1_f32_launch") else sig
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, log)
    _build._finish("enc1", *shipped)
    return libs


def ptxas(log: str, kernel: str):
    """(registers, spill bytes) that ptxas gave ``kernel``."""
    part = log[log.find(kernel):]
    regs = re.search(r"Used (\d+) registers", part)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
    return (int(regs.group(1)) if regs else None,
            int(spill.group(1)) + int(spill.group(2)) if spill else None)


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


def inputs(gen, bsz, h, w, dt):
    """Seeded level-1 inputs on the card, scaled as chip_smoke's enc1 phase."""
    def u(*shape, fan_in):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) / math.sqrt(fan_in)).to("cuda", dt)

    x = torch.rand(bsz, 3, h + 4, w + 4, generator=gen).to("cuda", dt)
    a = torch.full((1,), 0.25, device="cuda", dtype=dt)
    return (x, u(64, 3, 3, 3, fan_in=27), u(64, fan_in=27), a, u(64, 64, 3, 3, fan_in=576),
            u(64, fan_in=576), a)


def f32_bound_ms(bsz, h, w):
    """The least time at fp32's non-tensor peak, as chip_smoke reckons it."""
    nbytes = 4 * (bsz * 3 * (h + 4) * (w + 4) + 64 * 27 + 64 * 576 + 130
                  + bsz * 64 * (h * w + (h // 2) * (w // 2)))
    flops = 2.0 * bsz * h * w * 64 * 576 + 2.0 * bsz * (h + 2) * (w + 2) * 64 * 27
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3


class F32Launch:
    """Raw launches of one fp32 build on fixed inputs and outputs."""

    def __init__(self, lib, args, parent: bool):
        x, w0, b0, a0, w1, b1, a1 = args
        bsz, _, hp, wp = x.shape
        self.h, self.w, self.bsz = hp - 4, wp - 4, bsz
        self.lib, self.parent, self.x = lib, parent, x
        self.w0 = w0.contiguous()
        self.w1r = w1.permute(1, 2, 3, 0).contiguous()
        self.ba = torch.cat([b0.reshape(-1), b1.reshape(-1), a0.reshape(1), a1.reshape(1)])
        self.l1 = torch.empty(bsz, 64, self.h, self.w, device="cuda")
        self.l2 = torch.empty(bsz, 64, self.h // 2, self.w // 2, device="cuda")

    def __call__(self):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (self.x.data_ptr(), self.w0.data_ptr(), self.w1r.data_ptr(), self.ba.data_ptr(),
                self.l1.data_ptr(), self.l2.data_ptr(), self.bsz, self.h, self.w)
        if self.parent:
            err = self.lib.enc1_f32_launch(*ptrs, stream)
        else:
            ty, tx = E.f32_tile_grid(self.h, self.w)
            n_sms = torch.cuda.get_device_properties(0).multi_processor_count
            err = self.lib.enc1_f32_launch(*ptrs, ty, tx,
                                           E.f32_cta_count(self.bsz * ty * tx, n_sms), stream)
        _build.check(err, "enc1_f32 parent" if self.parent else "enc1_f32")


def diff(a, b) -> float:
    return (a - b).abs().max().item()


def f32_shapes(libs, card, gen):
    """The fp32 rows: kernel alone, wrapper, parent, plain, bound, and the
    largest differences, at every shape."""
    torch.backends.cudnn.allow_tf32 = False
    whole = libs["whole"][0]
    parent = libs["parent"][0] if "parent" in libs else None
    for shape in F32_SHAPES + F32_RAGGED:
        timed = shape in F32_SHAPES
        args = inputs(gen, *shape, torch.float32)
        new = F32Launch(whole, args, False)
        old = F32Launch(parent, args, True) if parent else None
        new()
        r1, r2 = E.enc1_reference(*args)
        w1_, w2_ = E.enc1(*args)
        torch.cuda.synchronize()
        scale = max(1.0, r1.abs().max().item())
        row = {"kernel": "enc1_f32", "shape": list(shape),
               "max_abs_err_vs_plain": max(diff(new.l1, r1), diff(new.l2, r2)),
               "tol_vs_plain": 1e-4 * scale,
               "wrapper_equals_kernel": bool(torch.equal(w1_, new.l1) and torch.equal(w2_, new.l2))}
        if old is not None:
            old()
            torch.cuda.synchronize()
            row["max_abs_diff_vs_parent"] = max(diff(new.l1, old.l1), diff(new.l2, old.l2))
            row["bit_equal_to_parent"] = bool(torch.equal(new.l1, old.l1)
                                              and torch.equal(new.l2, old.l2))
        if timed:
            reps = 20 if shape[0] * shape[1] * shape[2] > 1e6 else 100
            fns = {"ms": new, "wrapper_ms": lambda: E.enc1(*args)}
            if old is not None:
                fns["parent_ms"] = old
            t = {k: [] for k in fns}
            for order in (list(fns), list(fns)[::-1]):
                for k in order:
                    t[k].append(time_ms(fns[k], reps))
            row.update({k: sum(v) / 2 for k, v in t.items()})
            row["rounds"] = t
            row["plain_ms"] = time_ms(lambda: E.enc1_reference(*args), reps)
            row["bound_ms"] = f32_bound_ms(*shape)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(json.dumps({**row, "card": card}), flush=True)
        del new, old, args
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(KERNEL), default="bfloat16")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier tree's csrc/enc1.cu whose fp32 kernel to time beside it")
    args = ap.parse_args(argv)
    if args.parent is not None and args.dtype != "float32":
        ap.error("--parent times the fp32 kernel: give --dtype float32")
    if not torch.cuda.is_available():
        raise SystemExit("enc1_breakdown: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    f32 = args.dtype == "float32"
    src = (_build.CSRC / "enc1.cu").read_text()
    sources = {name: variant_source(src, args.dtype, cuts) for name, cuts in VARIANTS.items()}
    if f32:
        sources.update({name: design_source(src, subs) for name, subs in DESIGN.items()})
    if args.parent is not None:
        sources["parent"] = parent_source(args.parent.read_text())
    libs = build(sources)
    for name, (_, log) in libs.items():
        regs, spills = ptxas(log, KERNEL[args.dtype])
        print(json.dumps({"kernel": KERNEL[args.dtype], "variant": name, "registers": regs,
                          "spill_bytes": spills, "card": card}))
    gen = torch.Generator().manual_seed(1)
    if f32:
        f32_shapes(libs, card, gen)
    bsz = args.batch or (30 if f32 else 8)
    h = args.size or (184 if f32 else 504)
    dt = torch.float32 if f32 else torch.bfloat16
    kargs = inputs(gen, bsz, h, h, dt)
    names = list(VARIANTS) + (list(DESIGN) if f32 else [])
    if f32:
        runs = {name: F32Launch(libs[name][0], kargs, False) for name in names}
        l1, l2 = runs["whole"].l1, runs["whole"].l2
        for name in names:
            runs[name]()
        torch.cuda.synchronize()
        equal = {name: bool(torch.equal(runs[name].l1, l1) and torch.equal(runs[name].l2, l2))
                 for name in DESIGN}
    else:
        x, w0, b0, a, w1, b1, _ = kargs
        w1p = E.pack_w1(w1)
        l1 = torch.empty(bsz, 64, h, h, device="cuda", dtype=dt)
        l2 = torch.empty(bsz, 64, h // 2, h // 2, device="cuda", dtype=dt)
        ty, tx = E.tile_grid(h, h)
        ctas = E.cta_count(bsz * ty * tx, torch.cuda.get_device_properties(0).multi_processor_count)
        stream = torch.cuda.current_stream().cuda_stream

        def bf16_run(name):
            def run():
                err = libs[name][0].enc1_bf16_launch(
                    x.data_ptr(), w0.data_ptr(), w1p.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                    a.data_ptr(), a.data_ptr(), l1.data_ptr(), l2.data_ptr(), bsz, h, h, ty, tx,
                    ctas, stream)
                _build.check(err, f"enc1 {name}")
            return run

        runs = {name: bf16_run(name) for name in VARIANTS}
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(time_ms(runs[name]))
    item = 4 if f32 else 2
    out_bytes = (l1.numel() + l2.numel()) * item
    fill = torch.empty(l1.numel() + l2.numel(), device="cuda", dtype=dt)
    write_ms = time_ms(lambda: fill.fill_(0))
    whole = sum(times["whole"]) / 2
    for name, t in times.items():
        ms = sum(t) / 2
        row = {"kernel": KERNEL[args.dtype], "variant": name, "shape": [bsz, h, h], "ms": ms,
               "ms_rounds": t, "whole_minus_variant_ms": whole - ms}
        if name in DESIGN and f32:
            row["bit_equal_to_whole"] = equal[name]
        print(json.dumps({**row, "card": card}))
    print(json.dumps({"kernel": "fill_", "bytes": out_bytes, "ms": write_ms,
                      "tb_per_s": out_bytes / write_ms / 1e9, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
