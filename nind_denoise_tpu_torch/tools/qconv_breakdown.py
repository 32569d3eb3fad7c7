"""Where P1's time goes: ``csrc/qconv.cu`` as it ships, beside a variant
with its epilogue cut out and, with ``--parent``, an earlier tree's
kernel, all timed in one process on the card, at the 21 int8 convs of the
funit-64 forward on 8 x 504^2 tiles.

    python -m nind_denoise_tpu_torch.tools.qconv_breakdown [--parent PATH]

Per shape and kernel: ``plain`` (bf16 out with the bias: the instance an
earlier kernel without epilogue options can run, so the fusions are off),
``fwd`` (the epilogue the PReLU forward gives that site:
``models/utnet_int8.site_epilogue``: the fp32 sum of a composed up-conv,
the decoder's sum with its addend and bias map, or bias and PReLU), and
``fwd_static`` (that, quantized to int8, where int8_static does so).
``no_epilogue`` is the shipped source with the epilogue cut out
(``plain``'s launch): the main loop alone. ``--parent`` takes the
``qconv.cu`` of an unpacked earlier tree whose C entry has 22 int
arguments and no epilogue pointers; it runs ``plain``. Every output is
held bit for bit: the shipped int32 sums against the parent's (or, with
no parent, against the plain float64 conv on the first sample), the
parent's bf16 against the shipped, each fused output against
``dequant_reference`` of the shipped int32 sums. Timings are raw launches
(no wrapper), warm, from CUDA events, interleaved over two rounds. One
JSON line per row, each with the card's name and power limit; first the
build times and the registers ptxas gave each kernel instance.
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

from ..models.utnet_int8 import conv_shapes, site_epilogue
from ..ops import _build
from ..ops import qconv as Q

# (old, new, occurrences) substitutions
VARIANTS = {
    "shipped": (),
    "no_epilogue": (("    if (it % p.ncc != p.ncc - 1) continue;",
                     "    if (it % p.ncc != p.ncc - 1 || p.n > 0) continue;", 1),),
}
PARENT_ENTRY = 'extern "C" int qconv_launch('
PARENT_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 + [ctypes.c_void_p]


def variant_source(src: str, subs) -> str:
    for old, new, n in subs:
        if src.count(old) != n:
            raise RuntimeError(f"qconv.cu no longer has {old!r} {n} times")
        src = src.replace(old, new)
    return src


def _start(out: Path, name: str, src: str):
    cu = out / f"{name}.cu"
    cu.write_text(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o", str(out / f"{name}.so"),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(sources):
    """{name: (ctypes library, ptxas log, nvcc seconds)}, one nvcc each, all
    at once."""
    out = _build.BUILD_DIR / "qconv_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = {n: _start(out, n, s) for n, s in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.qconv_launch.argtypes = PARENT_SIG if name == "parent" else Q._SIG["qconv_launch"]
        lib.qconv_launch.restype = ctypes.c_int
        libs[name] = (lib, log, time.time() - t0)
    return libs


def registers(log: str):
    """{kernel instance: [registers, spilled bytes stored]} from ptxas's
    log."""
    regs, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = re.sub(r"^_ZN\w*?qconv_kernel", "qconv_kernel", m.group(1))[:40]
            regs[fn] = [None, 0]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn is not None:
            regs[fn][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            regs[fn][0] = int(m.group(1))
    return regs


def time_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
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
                    help="an earlier tree's csrc/qconv.cu to time beside it")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("qconv_breakdown: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    src = (_build.CSRC / "qconv.cu").read_text()
    sources = {name: variant_source(src, subs) for name, subs in VARIANTS.items()}
    if args.parent is not None:
        parent = args.parent.read_text()
        if parent.count(PARENT_ENTRY) != 1:
            raise RuntimeError(f"the parent source lacks {PARENT_ENTRY!r}")
        sources["parent"] = parent
    libs = build(sources)
    for name, (_, log, secs) in libs.items():
        print(json.dumps({"kernel": "qconv", "variant": name, "nvcc_seconds": secs,
                          "registers": registers(log), "card": card}))
    dev, n = "cuda", args.batch
    gen = torch.Generator(device=dev).manual_seed(31)
    stream = torch.cuda.current_stream().cuda_stream
    totals = {}
    for site, h, cin, cout, k, pads, dil in conv_shapes():
        kind, static_q = site_epilogue(site)
        ho, wo = Q.out_hw(h, h, k, k, pads, dil)
        xq = torch.randint(-127, 128, (n, h, h, cin), dtype=torch.int8, device=dev, generator=gen)
        wk = torch.randint(-127, 128, (cout, k, k, cin), dtype=torch.int8, device=dev,
                           generator=gen)
        sx = torch.rand(1, device=dev, generator=gen) * 1e-2 + 1e-3
        sw = torch.rand((2, cout) if site == "K3fq" else (cout,), device=dev,
                        generator=gen) * 1e-3 + 1e-4
        bias = torch.rand(cout, device=dev, generator=gen) - 0.5
        a = torch.full((1,), 0.25, device=dev)
        qs = torch.full((1,), 0.02, device=dev)
        big = kind == "sum"
        addend = torch.randn(n, ho, wo, cout, device=dev, generator=gen) if big else None
        bmap = torch.randn(1, ho, wo, cout, device=dev, generator=gen) if big else None
        outs = {}

        def launch(name, kind_=2, out=None, ad=None, bm=None, pr=None, q=None, bi=bias):
            lib = libs[name][0]
            ptr = lambda t: 0 if t is None or kind_ == 0 else t.data_ptr()
            common = [xq.data_ptr(), wk.data_ptr(), out.data_ptr(), ptr(sx),
                      ptr(sw), ptr(bi), n, h, h, cin, ho, wo, cout, k, k, pads[0],
                      pads[2], dil, 0, int(sw.dim() == 2), kind_, 1]
            extra = [] if name == "parent" else [ptr(ad), ptr(bm), ptr(pr), ptr(q)]
            _build.check(lib.qconv_launch(*common, *extra, stream), f"qconv {name}")

        def new(dtype):
            return torch.empty((n, ho, wo, cout), dtype=dtype, device=dev)

        runs = {}
        o16 = {name: new(torch.bfloat16) for name in libs}
        for name in libs:
            runs[(name, "plain")] = lambda name=name: launch(name, out=o16[name])
        o32, ofw = new(torch.int32), new(torch.float32 if kind == "raw" else torch.bfloat16)
        fw = dict(bi=None) if kind == "raw" else dict(pr=a, ad=addend, bm=bmap)
        runs[("shipped", "fwd")] = lambda: launch("shipped", 1 if kind == "raw" else 2,
                                                  out=ofw, **fw)
        if static_q:
            o8 = new(torch.int8)
            runs[("shipped", "fwd_static")] = lambda: launch("shipped", out=o8, q=qs, **fw)
        # correctness, once
        for fn in runs.values():
            fn()
        launch("shipped", 0, out=o32, bi=None)
        if "parent" in libs:
            p32 = new(torch.int32)
            launch("parent", 0, out=p32, bi=None)
            exact = torch.equal(o32, p32) and torch.equal(o16["parent"], o16["shipped"])
        else:
            exact = torch.equal(o32[:1], Q.conv_i32_reference(xq[:1], wk, pads, dil))
        ref16 = Q.dequant_reference(o32, sx, sw, bias, torch.bfloat16)
        fwd_ref = (Q.dequant_reference(o32, sx, sw, None, torch.float32) if kind == "raw" else
                   Q.dequant_reference(o32, sx, sw, bias, torch.bfloat16, addend, bmap, a))
        exact = exact and torch.equal(o16["shipped"], ref16) and torch.equal(ofw, fwd_ref)
        if static_q:
            exact = exact and torch.equal(o8, Q.quant_act_static(fwd_ref, qs)[0])
        if not exact:
            raise RuntimeError(f"qconv {site}: a kernel is not bit-equal to its plain version")
        times = {key: [] for key in runs}
        keys = list(runs)
        for order in (keys, keys[::-1]):
            for key in order:
                times[key].append(time_ms(runs[key]))
        row = {f"{name}_{what}": sum(t) / 2 for (name, what), t in times.items()}
        for key, v in row.items():
            totals[key] = totals.get(key, 0.0) + v
        print(json.dumps({"kernel": "qconv", "site": site, "input": [n, h, h, cin], "cout": cout,
                          "k": k, "lhs_dilation": dil, "epilogue": kind, "bit_equal": True,
                          "ms": row, "card": card}), flush=True)
        del xq, wk, addend, bmap, outs, o16, o32, ofw
        torch.cuda.empty_cache()
    print(json.dumps({"kernel": "qconv", "sum_ms": totals, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
