"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``nind_denoise_tpu_torch``). Prints one JSON object as
the last line of standard output; the numbers the check compared, each
beside its limit, are the last lines of standard error. Exits 1 without a
result when there is no CUDA device, too few of them, a module of JAX or
of the JAX package is loaded, or the run fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# Python's compiled bytecode, torch's included, is cached inside the
# checkout at a fixed path, also where the environment asks Python to
# write none: the first run compiles what it imports, later runs load it
sys.pycache_prefix = str(REPO / "build" / "portbench_cache" / "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, str(REPO))

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.bench import Benchmark, banned_modules, cache_dirs, run_cell

    cache_dirs(REPO)
    import torch

    phases = {"import": time.perf_counter() - T_START}
    chips = Benchmark(REPO).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 1
    t = time.perf_counter()
    torch.empty(1, device="cuda:0")  # the card's context
    phases["context"] = time.perf_counter() - t
    result, lines, _ = run_cell(REPO, args.workload, args.seed, args.seconds, bool(args.trace),
                                device="cuda:0", t_start=T_START, phases=phases)
    found = banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
