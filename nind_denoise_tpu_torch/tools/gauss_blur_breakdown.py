"""Where K3's time goes: ``csrc/gauss_blur.cu`` as it ships, beside
variants with one design choice undone and, with ``--parent``, an earlier
tree's kernel, all timed in one process on the card.

    python -m nind_denoise_tpu_torch.tools.gauss_blur_breakdown [--parent PATH]

The shipped source is built alone first, and the seconds its ``nvcc``
took are reported; then the variants, each the shipped source with one
substitution, and the parent are built together, one nvcc each: 64-wide
tiles at every radius (``tw64``), vertical passes one row a thread
(``kv1``) and the HWC output stored channel by channel instead of
gathered in shared memory (``no_stage``). ``--parent`` takes the
``gauss_blur.cu`` of an unpacked earlier tree, which must have the same
two C entries (``parent``). Timings are raw launches (no wrapper), warm, from CUDA
events, interleaved over two rounds; every variant is checked bit for bit
against the plain version. ``copy_`` of the input into the output moves
the kernel's 8 bytes an element, for comparison. One JSON line per row,
each with the card's name and power limit; first the build time, the
registers ptxas gave the shipped kernel at each radius, and the static
SASS instruction counts (by class) of a few of its instances.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

import torch

from ..ops import _build
from ..ops import gauss_blur as G
from ..ops import rl_fused
from ..ops.rl_deblur import gaussian_taps_np

# (old, new, occurrences) substitutions
VARIANTS = {
    "shipped": (),
    "tw64": (("TW = R <= 16 ? 64 : 128;", "TW = 64;", 1),),
    "kv1": (("constexpr int KV = 8;", "constexpr int KV = 1;", 1),),
    "no_stage": (("const bool stage = C > 1 &&", "const bool stage = false &&", 1),),
}
# the C entries a parent must have, with the signatures of ops/gauss_blur.py
ENTRIES = ('extern "C" int gauss_blur_launch(', 'extern "C" int gauss_blur_planes_launch(')
# (shape, sigma): HWC (H, W, C) through gauss_blur_launch, planar (P, H, W)
# through gauss_blur_planes_launch; sigma 10 and 11 are R 30 and R 33
SHAPES = (("hwc", (2000, 3000, 3), 1.0), ("hwc", (2000, 3000, 3), 21.0),
          ("planes", (3, 2000, 3000), 10.0), ("planes", (3, 2000, 3000), 11.0))
REGISTER_RADII = (3, 16, 33, 63)


def variant_source(src: str, subs) -> str:
    for old, new, n in subs:
        if src.count(old) != n:
            raise RuntimeError(f"gauss_blur.cu no longer has {old!r} {n} times")
        src = src.replace(old, new)
    return src


def parent_source(src: str) -> str:
    """An earlier ``gauss_blur.cu``, checked to have the C entries the
    wrappers call."""
    for entry in ENTRIES:
        if src.count(entry) != 1:
            raise RuntimeError(f"the parent source lacks {entry!r}")
    return src


def _start(out: Path, name: str, src: str):
    cu = out / f"{name}.cu"
    cu.write_text(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o", str(out / f"{name}.so"),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(out: Path, name: str, proc):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    for fn, argtypes in G._SIG.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib, log


def build(sources):
    """({name: (ctypes library, ptxas log)}, seconds of the first
    source's nvcc, run alone) for {name: source text}; the rest are built
    together, one nvcc each."""
    out = _build.BUILD_DIR / "gauss_blur_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    names = list(sources)
    t0 = time.time()
    libs = {names[0]: _load(out, names[0], _start(out, names[0], sources[names[0]]))}
    seconds = time.time() - t0
    procs = {n: _start(out, n, sources[n]) for n in names[1:]}
    libs.update({n: _load(out, n, p) for n, p in procs.items()})
    return libs, seconds


def registers(log: str):
    """{radius: registers} from ptxas's log of the templated kernel; raises
    on a spill."""
    regs, radius = {}, None
    for line in log.splitlines():
        m = re.search(r"gauss_blur_kernelILi(\d+)E", line)
        if m:
            radius = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and radius is not None:
            regs[radius] = int(m.group(1))
        if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
            raise RuntimeError(f"the shipped kernel spills: {line.strip()}")
    return dict(sorted(regs.items()))


def sass_counts(so: Path, radii):
    """{radius: {opcode class: count}} over the SASS of the templated
    kernel's instances in ``so`` (static instructions, from cuobjdump)."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for r in radii:
        m = re.search(rf"Function : _Z\S*gauss_blur_kernelILi{r}E\S*\n(.*?)(?=\n\s*Function :|\Z)",
                      sass, re.S)
        if m is None:
            raise RuntimeError(f"no SASS for the radius {r} instance")
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", m.group(1))
        count = {k: sum(op == k for op in ops) for k in ("FMUL", "FADD", "LDS", "LDG", "STS", "STG")}
        out[r] = {"total": len(ops), **count, "other": len(ops) - sum(count.values())}
    return out


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
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier tree's csrc/gauss_blur.cu to time beside it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gauss_blur_breakdown: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    src = (_build.CSRC / "gauss_blur.cu").read_text()
    sources = {name: variant_source(src, subs) for name, subs in VARIANTS.items()}
    if args.parent is not None:
        sources["parent"] = parent_source(args.parent.read_text())
    libs, seconds = build(sources)
    regs = registers(libs["shipped"][1])
    so = _build.BUILD_DIR / "gauss_blur_breakdown" / "shipped.so"
    print(json.dumps({"kernel": "gauss_blur", "variant": "shipped", "nvcc_seconds": seconds,
                      "registers_by_radius": regs,
                      "registers": {r: regs.get(r) for r in REGISTER_RADII},
                      "sass": sass_counts(so, REGISTER_RADII), "card": card}))
    gen = torch.Generator().manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    for entry, shape, sigma in SHAPES:
        x = torch.rand(*shape, generator=gen).to("cuda")
        taps = gaussian_taps_np(sigma)
        tt = torch.from_numpy(taps).to("cuda")
        r = (len(taps) - 1) // 2
        if entry == "hwc":
            ref = G.gauss_blur_reference(x, sigma)
        else:
            ref = rl_fused.blur(x, taps.tolist())
        outs = {n: torch.empty_like(x) for n in libs}

        def run(name):
            lib = libs[name][0]
            if entry == "hwc":
                err = lib.gauss_blur_launch(x.data_ptr(), outs[name].data_ptr(), tt.data_ptr(),
                                            *shape, r, stream)
            else:
                err = lib.gauss_blur_planes_launch(x.data_ptr(), outs[name].data_ptr(),
                                                   tt.data_ptr(), *shape, r, stream)
            _build.check(err, f"gauss_blur {name}")

        errs = {}
        for name in libs:
            run(name)
            errs[name] = (outs[name] - ref).abs().max().item()
            if errs[name] != 0:
                raise RuntimeError(f"variant {name} at {shape} sigma {sigma}: error {errs[name]}")
        names = list(libs)
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(time_ms(lambda: run(name)))
        shipped = sum(times["shipped"]) / 2
        for name, t in times.items():
            print(json.dumps({"kernel": "gauss_blur", "variant": name, "entry": entry,
                              "shape": list(shape), "sigma": sigma, "radius": r,
                              "ms": sum(t) / 2, "ms_rounds": t,
                              "over_shipped": sum(t) / 2 / shipped,
                              "max_abs_err": errs[name], "card": card}))
        o = torch.empty_like(x)
        print(json.dumps({"kernel": "copy_", "shape": list(shape), "bytes": 8 * x.numel(),
                          "ms": time_ms(lambda: o.copy_(x)), "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
