"""Where P2's time goes: ``csrc/deriche.cu`` as it ships, beside variants
with one design choice undone or one phase cut out and, with ``--parent``,
an earlier tree's kernel, all timed in one process on the card.

    python -m nind_denoise_tpu_torch.tools.deriche_breakdown [--parent PATH]

Every source is the shipped one with one substitution, built together
(one nvcc each, ``-Xptxas -v``): chunks of 16 instead of 32 (``l16``; its
own geometry, so along H a 2000 line is two segments and two launches),
shared memory without the pad word along H and the granule swizzle along
W (``plain_layout``: the chunks a warp walks share banks), the chunk scan
cut out (``no_scan``), and the three compute phases cut out, so the tile
is only loaded and stored (``copy``); and the shipped source with clock64
stamps (``clocks``), whose one extra launch a case reports the cycles a
CTA spends in each phase (summed by thread 0 of each CTA). ``--parent``
takes the
``deriche.cu`` of an unpacked earlier tree, the thread-a-line kernel with
its single C entry (``parent``). Timings are raw launches (no wrapper),
warm, from CUDA events, interleaved over two rounds, at the CLI's (3,
2000, 3000) and a server group's (24, 480, 480) planes, sigma 1 and 10,
each axis. The shipped kernel, ``plain_layout`` and ``l16`` are held bit
for bit to ``deriche_axis_chunked`` at their chunk length; they and the
parent within ``error_bound`` of the float64 loop; the cut variants are
not checked. ``copy_`` of the input into the output moves the kernel's 8
bytes an element. One JSON line per row, each with the card's name and
power limit; first the registers, stack frame and spills ptxas gave each
build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops import deriche as D

# name: ((old, new, occurrences) substitutions, chunk length)
VARIANTS = {
    "shipped": ((), D.CHUNK),
    "l16": ((("constexpr int L = 32;", "constexpr int L = 16;", 1),), 16),
    "plain_layout": ((("constexpr int LP = L + 1;", "constexpr int LP = L;", 1),
                      ("constexpr int SWZ = L / 4 - 1;", "constexpr int SWZ = 0;", 1)), D.CHUNK),
    "no_scan": ((("base < 2 * G;", "base < 0;", 1),), D.CHUNK),
    "copy": ((("base < 2 * G;", "base < 0;", 1),
              ("if (mine) {", "if (false && mine) {", 3)), D.CHUNK),
}
CHECKED = ("shipped", "l16", "plain_layout", "clocks")
# the clocks variant: thread 0 of each CTA adds the cycles since its last
# stamp at each of these points (the tile loaded; its chunks and edge
# values read; phase a; the scan; phase c; the stores issued)
PHASES = ("load", "reads", "a", "scan", "c", "store")
PARENT_ENTRY = 'extern "C" int deriche_launch(const void* x, void* y, int p, int h, int w,'
PARENT_SIG = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 8 + [ctypes.c_void_p]
SHAPES = ((3, 2000, 3000), (24, 480, 480))


def variant_source(src: str, subs) -> str:
    for old, new, n in subs:
        if src.count(old) != n:
            raise RuntimeError(f"deriche.cu no longer has {old!r} {n} times")
        src = src.replace(old, new)
    return src


def clock_source(src: str) -> str:
    """The shipped source with clock64 stamps after each barrier of the
    kernel and after its stores, summed over CTAs into a device array that
    the C entry ``deriche_clocks`` reads out and zeroes."""
    anchor = "  const int u = blockIdx.x;\n"
    head, found, body = src.partition(anchor)
    kernel, end, rest = body.partition("\n}\n")
    if not found or not end:
        raise RuntimeError("deriche.cu no longer has the kernel's tile index")
    lines, phase = [], 0
    for line in kernel.split("\n"):
        lines.append(line)
        if line.strip() in ("__syncthreads();", "store_tile<GH>(q, t, xs);"):
            lines.append(f"    if (threadIdx.x == 0) {{ const long long c = clock64(); "
                         f"atomicAdd(&deriche_clk[{phase}], (unsigned long long)(c - clk0)); "
                         f"clk0 = c; }}")
            phase += 1
    if phase != len(PHASES):
        raise RuntimeError(f"deriche.cu has {phase} stamp points, not {len(PHASES)}")
    head = head.replace("namespace {\n", "__device__ unsigned long long deriche_clk[8];\n"
                        "namespace {\n", 1)
    return (head + anchor + "  long long clk0 = clock64();\n" + "\n".join(lines) + end
            + rest + "\nextern \"C\" int deriche_clocks(unsigned long long* out) {\n"
            "  cudaError_t e = cudaMemcpyFromSymbol(out, deriche_clk, sizeof(deriche_clk));\n"
            "  const unsigned long long z[8] = {0};\n"
            "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(deriche_clk, z, sizeof(z));\n"
            "  return (int)e;\n}\n")


def parent_source(src: str) -> str:
    """An earlier ``deriche.cu``, checked to have the one-line-a-thread C
    entry."""
    if src.count(PARENT_ENTRY) != 1:
        raise RuntimeError("the parent source lacks the thread-a-line deriche_launch")
    return src


def build(sources):
    """{name: (ctypes library, ptxas log)} for {name: source text}, one
    nvcc each, all at once."""
    out = _build.BUILD_DIR / "deriche_breakdown"
    out.mkdir(parents=True, exist_ok=True)
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
        lib.deriche_launch.argtypes = PARENT_SIG if name == "parent" else D._SIG["deriche_launch"]
        lib.deriche_launch.restype = ctypes.c_int
        if name == "clocks":
            lib.deriche_clocks.argtypes = [ctypes.c_void_p]
            lib.deriche_clocks.restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


def ptxas(log: str):
    """(registers, stack frame bytes, spill bytes) from ptxas's log of the
    one kernel."""
    regs = re.search(r"Used (\d+) registers", log)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", log)
    return (int(regs.group(1)) if regs else None, int(frame.group(1)) if frame else None,
            int(frame.group(2)) + int(frame.group(3)) if frame else None)


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
                    help="an earlier tree's csrc/deriche.cu to time beside it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("deriche_breakdown: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    src = (_build.CSRC / "deriche.cu").read_text()
    sources = {name: variant_source(src, subs) for name, (subs, _) in VARIANTS.items()}
    sources["clocks"] = clock_source(src)
    if args.parent is not None:
        sources["parent"] = parent_source(args.parent.read_text())
    libs = build(sources)
    for name, (_, log) in libs.items():
        regs, frame, spills = ptxas(log)
        print(json.dumps({"kernel": "deriche", "variant": name, "registers": regs,
                          "stack_frame_bytes": frame, "spill_bytes": spills, "card": card}))
    gen = torch.Generator().manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in SHAPES:
        x = (torch.rand(*shape, generator=gen) + 0.05).to("cuda")
        p, h, w = shape
        for sigma in (1.0, 10.0):
            c = [D.coeffs(sigma)[k] for k in D.KEYS]
            for axis in (1, 2):
                n = shape[axis]
                outs = {name: torch.empty_like(x) for name in libs}
                plans = {name: D.launch_plan(n, axis, sigma, chunk)
                         for name, (_, chunk) in VARIANTS.items()}
                plans["clocks"] = plans["shipped"]
                counts = {}

                def run(name):
                    lib = libs[name][0]
                    if name == "parent":
                        _build.check(lib.deriche_launch(x.data_ptr(), outs[name].data_ptr(), p, h,
                                                        w, axis, *c, stream), "parent")
                        counts[name] = 1
                    else:
                        counts[name] = D.launch(lib, x, outs[name], axis, plans[name])

                y64 = D.deriche_axis_reference(x.double(), sigma, axis)
                bound = D.error_bound(sigma, x.abs().max().item())
                errs = {}
                for name in libs:
                    run(name)
                    if name in CHECKED:
                        mirror = D.deriche_axis_chunked(x, sigma, axis, D.CHUNK if name == "clocks"
                                                        else VARIANTS[name][1])
                        if not torch.equal(outs[name], mirror):
                            raise RuntimeError(f"{name} at {shape} sigma {sigma} axis {axis} "
                                               "differs from the chunked order")
                    if name in CHECKED or name == "parent":
                        errs[name] = (outs[name].double() - y64).abs().max().item()
                        if errs[name] > bound:
                            raise RuntimeError(f"{name} at {shape} sigma {sigma} axis {axis}: "
                                               f"error {errs[name]} over the bound {bound}")
                names = list(libs)
                times = {name: [] for name in names}
                for order in (names, names[::-1]):
                    for name in order:
                        times[name].append(time_ms(lambda: run(name)))
                shipped = sum(times["shipped"]) / 2
                bound_ms = 8.0 * x.numel() / 3.35e12 * 1e3
                for name, t in times.items():
                    print(json.dumps({"kernel": "deriche", "variant": name, "shape": list(shape),
                                      "sigma": sigma, "axis": axis, "launches": counts[name],
                                      "ms": sum(t) / 2, "ms_rounds": t,
                                      "over_shipped": sum(t) / 2 / shipped,
                                      "bound_ms": bound_ms, "max_abs_err_f64": errs.get(name),
                                      "error_bound": bound, "card": card}))
                # cycles a CTA by phase, from one more launch of the clocks build
                lib = libs["clocks"][0]
                clk = (ctypes.c_ulonglong * 8)()
                _build.check(lib.deriche_clocks(clk), "deriche_clocks")
                run("clocks")
                torch.cuda.synchronize()
                _build.check(lib.deriche_clocks(clk), "deriche_clocks")
                g = plans["shipped"][0]
                ctas = (p * -(-w // g.lines) if axis == 1 else -(-p * h // g.lines)) * g.segments
                print(json.dumps({"kernel": "deriche", "variant": "clocks", "shape": list(shape),
                                  "sigma": sigma, "axis": axis, "ctas": ctas,
                                  "cycles_a_cta": {ph: clk[i] / ctas
                                                   for i, ph in enumerate(PHASES)},
                                  "card": card}))
        o = torch.empty_like(x)
        print(json.dumps({"kernel": "copy_", "shape": list(shape), "bytes": 8 * x.numel(),
                          "ms": time_ms(lambda: o.copy_(x)), "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
