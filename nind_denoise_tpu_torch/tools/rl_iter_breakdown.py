"""Where K1's time goes: ``csrc/rl_iter.cu`` with one of its design
choices undone, timed against the kernel as it ships on the card.

    python -m nind_denoise_tpu_torch.tools.rl_iter_breakdown [--parent PATH]

Each variant is the kernel's source with one substitution, built by nvcc
beside the kernels: 32-wide tiles at every radius (``tw32``), vertical
passes one row a thread (``kv1``), the est pass one column a thread
(``scalar_est``), and the division replaced by a multiply (``no_div``, whose
output is wrong by design). ``--parent`` adds the earlier kernel
(``rl_iter.cu`` of an unpacked earlier tree, one CTA per 32 x 32 tile,
radius at run time, radius limit 16; same C entry), with its radius limit
raised to 32 (``parent``) and also with its radius fixed at 3 at compile time
(``parent_r3``, sigma 1 only), which turns its divisions by the tile
width into multiplies and lets its tap loops unroll. Timings are raw
launches (no wrapper), warm, from CUDA events, interleaved over two rounds;
every variant but ``no_div`` is checked bit for bit against
``rl_iter_reference``. ``torch.add`` of two tensors into a third moves the
kernel's 12 bytes a pixel, for comparison. One JSON line per variant and
shape, each with the card's name and power limit; first the registers
ptxas gave the shipped kernel at each radius.
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
from ..ops import rl_fused as R
from ..ops.rl_deblur import gaussian_taps_np

# (old, new, occurrences) substitutions
VARIANTS = {
    "shipped": (),
    "tw32": (("TW = R <= 8 ? 64 : 32;", "TW = 32;", 1),),
    "kv1": (("constexpr int KV = 8;", "constexpr int KV = 1;", 1),),
    "scalar_est": (("if (q0 + 4 <= EW && gx0 >= 0", "if (false && gx0 >= 0", 1),),
    "no_div": (("__fdiv_rn(", "__fmul_rn(", 5),),
}
# the earlier kernel took R <= 16; it is timed with its limit at 32, the
# shared-memory layout it had fitting R 32 as well
_PARENT_R32 = (("constexpr int MAX_R = 16;", "constexpr int MAX_R = 32;", 1),
               ("constexpr int KPAD = 36;", "constexpr int KPAD = 68;", 1))
PARENT = {
    "parent": _PARENT_R32,
    "parent_r3": _PARENT_R32 + (
        ("int H, int W, int R) {", "int H, int W, int) {\n  constexpr int R = 3;", 1),),
}
SHAPES = (((3, 2000, 3000), 1.0), ((24, 480, 480), 1.0), ((3, 2000, 3000), 10.0))


def variant_source(src: str, subs) -> str:
    for old, new, n in subs:
        if src.count(old) != n:
            raise RuntimeError(f"rl_iter.cu no longer has {old!r} {n} times")
        src = src.replace(old, new)
    return src


def build(sources):
    """{name: (ctypes library, ptxas log)} for {name: source text}, one
    nvcc each, in parallel."""
    out = _build.BUILD_DIR / "rl_iter_breakdown"
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
        lib.rl_iter_launch.argtypes = R._SIG["rl_iter_launch"]
        lib.rl_iter_launch.restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


def registers(log: str):
    """{radius: registers} from ptxas's log of the templated kernel."""
    regs, radius = {}, None
    for line in log.splitlines():
        m = re.search(r"rl_iter_kernelILi(\d+)E", line)
        if m:
            radius = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and radius is not None:
            regs[radius] = int(m.group(1))
        if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
            raise RuntimeError(f"the shipped kernel spills: {line.strip()}")
    return dict(sorted(regs.items()))


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
                    help="an earlier tree's csrc/rl_iter.cu to time beside it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rl_iter_breakdown: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    src = (_build.CSRC / "rl_iter.cu").read_text()
    sources = {name: variant_source(src, subs) for name, subs in VARIANTS.items()}
    if args.parent is not None:
        psrc = args.parent.read_text()
        sources.update({name: variant_source(psrc, subs) for name, subs in PARENT.items()})
    libs = build(sources)
    print(json.dumps({"kernel": "rl_iter", "variant": "shipped",
                      "registers_by_radius": registers(libs["shipped"][1]), "card": card}))
    gen = torch.Generator().manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, sigma in SHAPES:
        d = (torch.rand(*shape, generator=gen) + 0.05).to("cuda")
        taps = gaussian_taps_np(sigma)
        tt = torch.from_numpy(taps).to("cuda")
        r = (len(taps) - 1) // 2
        ref = R.rl_iter_reference(d, d, taps)
        names = [n for n in libs if r == 3 or n != "parent_r3"]
        outs = {n: torch.empty_like(d) for n in names}

        def run(name):
            err = libs[name][0].rl_iter_launch(d.data_ptr(), d.data_ptr(), outs[name].data_ptr(),
                                               tt.data_ptr(), *shape, r, stream)
            _build.check(err, f"rl_iter {name}")

        errs = {}
        for name in names:
            run(name)
            errs[name] = (outs[name] - ref).abs().max().item()
            if name != "no_div" and errs[name] != 0:
                raise RuntimeError(f"variant {name} at {shape} sigma {sigma}: error {errs[name]}")
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(time_ms(lambda: run(name)))
        shipped = sum(times["shipped"]) / 2
        for name, t in times.items():
            print(json.dumps({"kernel": "rl_iter", "variant": name, "shape": list(shape),
                              "sigma": sigma, "radius": r, "ms": sum(t) / 2, "ms_rounds": t,
                              "over_shipped": sum(t) / 2 / shipped,
                              "max_abs_err": errs[name], "card": card}))
        e, o = d + 1, torch.empty_like(d)
        print(json.dumps({"kernel": "torch.add", "shape": list(shape), "bytes": 12 * d.numel(),
                          "ms": time_ms(lambda: torch.add(d, e, out=o)), "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
