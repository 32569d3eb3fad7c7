"""Read the numbers a cell's check compares, over many seeds in one process:
the program's sound runs (the lower readings), the control in the
program's place (the upper readings) and planted faults.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--controls program_int8|reference_fp8|reference_tf32] [--control-seeds 4,5,6] \\
        [--faults half_batch,unchanged] [--fault-seeds 7,8,9] [--seconds 3] [--out FILE]

Each seed is one set-up, a short window at the cell's own load (long
enough for the check's sample) and the check, at the cell's own sizes.
One JSON line a reading goes to standard output and to ``--out``. Needs a
CUDA device; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def one(bench, cell, seed: int, seconds: float, control=None, fault=None,
        device="cuda:0") -> dict:
    """One seed: set-up, a window of ``seconds`` and the check; with
    ``control``, the control in the program's place (the TF32 reference
    has no window: its steps are the check's); with ``fault``, the fault
    planted under all of it."""
    import torch

    from .bench import LOOPS
    from .faults import planted
    from .loops.photos import _sync

    config, traffic = bench.config(cell), bench.traffic(cell)
    t0 = time.perf_counter()
    rec = None
    with planted(fault) if fault else contextlib.nullcontext():
        loop = LOOPS[traffic["loop"]](config, traffic, device, seed)
        phases = {}
        for phase in ("prepare", "build", "warm"):
            t = time.perf_counter()
            if phase == "build" and control == "program_int8":
                loop.build(compute_dtype="int8")
            elif phase == "build" and control == "reference_fp8":
                loop.build()
                loop.one = lambda raw, spans=None, sync=False: _fp8_in_place(loop, raw)
            elif phase == "warm" and control == "reference_tf32":
                _tf32_in_place(loop)
            else:
                getattr(loop, phase)()
            _sync(device)
            phases[phase] = time.perf_counter() - t
        if control != "reference_tf32":
            rec = loop.window(seconds, False)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loop.free()
    if cuda:
        torch.cuda.empty_cache()
    readings = loop.check()
    out = {"cell": cell["name"], "seed": seed, "control": control, "fault": fault,
           "readings": readings, "attempted": rec["attempted"] if rec else 0,
           "failed": rec["failed"] if rec else 0, "e2e": loop.end_to_end(rec) if rec else {},
           "peak_bytes": peak, "phases": phases, "seconds": time.perf_counter() - t0}
    if hasattr(loop, "detail"):
        out["detail"] = loop.detail
    del loop, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def _fp8_in_place(loop, raw):
    """The plain reference with float8 e4m3 convolution operands, as the
    timed path's one image."""
    canvas, u8 = loop._reference(raw, fp8=True)
    return canvas, u8.cpu().numpy()


def _tf32_in_place(loop) -> None:
    """The plain reference with TF32 on, in the program's place: its
    checked steps' readings, as the window takes the program's."""
    import torch

    from .loops.train import _named_norms

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        losses, g1, p3, w0 = loop.reference(torch.float32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    grad1 = _named_norms(g1)
    change = _named_norms({k: p3[k] - w0[k] for k in p3})
    loop.taken = {"loss1": losses[0],
                  "grad1": torch.tensor([grad1[n] for n in loop.names], dtype=torch.float64),
                  "change": torch.tensor([change[n] for n in loop.names], dtype=torch.float64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--controls", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from .bench import Benchmark, cache_dirs

    cache_dirs(REPO)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    bench = Benchmark(REPO)
    cell = bench.cell(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    runs = [(s, None, None) for s in ints(args.seeds)]
    runs += [(s, c, None) for c in args.controls.split(",") if c for s in ints(args.control_seeds)]
    runs += [(s, None, f) for f in args.faults.split(",") if f for s in ints(args.fault_seeds)]
    sink = open(args.out, "a") if args.out else None
    try:
        for seed, control, fault in runs:
            line = json.dumps(one(bench, cell, seed, args.seconds, control, fault))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
