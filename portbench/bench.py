"""The harness: finds a cell's files by the names in ``BENCHMARK.json``
and runs it once.

- ``configs/<config>.json`` (named by the configuration's ``file``): the
  network, its widths, the engine's settings (``inference``) and the
  training preset (``training``).
- ``traffic/<traffic>.json``: the mix's parameters; its ``loop`` names the
  general loop in ``loops/`` (``photos`` or ``train``).
- ``limits/<cell>.json``: each number the check compares, with its limit
  and the readings it was set from.
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None (nothing to read: the metric is left
  out of the line).

``run_cell`` runs set-up, the window and the check on a device and
returns the result line; ``run.py`` is the command.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from .loops.photos import PhotoLoop
from .loops.train import TrainLoop
from .profiling import TraceContext

LOOPS = {"photos": PhotoLoop, "train": TrainLoop}
# modules that may not be loaded in a run: compared by whole top-level name
BANNED = ("jax", "jaxlib", "flax", "nind_denoise_tpu")


class Benchmark:
    def __init__(self, repo_root: Path):
        self.repo = Path(repo_root)
        self.spec = json.loads((self.repo / "BENCHMARK.json").read_text())
        self.home = self.repo / "portbench"

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.repo / c["file"]).read_text())
        raise KeyError(f"no configuration {cell['config']!r}")

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.home / "traffic" / f"{cell['traffic']}.json").read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads((self.home / "limits" / f"{cell['name']}.json").read_text())

    def end_to_end(self, cell: dict):
        return [m for m in self.spec["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict, reported_e2e):
        names = {m["name"] for m in reported_e2e}
        return [m for m in self.spec["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in names else [])]

    def reader(self, metric: str):
        path = self.home / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def compare(readings: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each limited number beside its limit; a reading is within its
    limit when it is at most the limit."""
    out = {}
    for name, lim in limits["numbers"].items():
        v = readings.get(name)
        out[name] = {"value": v, "limit": lim["limit"],
                     "ok": v is not None and v == v and v <= lim["limit"]}
    return out


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def device_block(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": _power_limit()}


def _power_limit() -> Optional[float]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(repo_root, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None, phases: Optional[dict] = None):
    """One run of a cell: (the result line as a dict, the check's lines,
    every reading of the check). ``t_start``: the process's start on the
    host clock (set-up counts from it). The line's ``setup_phases`` splits
    set-up: ``phases`` (what the caller timed before, from ``t_start``),
    then the loop's ``prepare``, ``build`` and ``warm``."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Benchmark(repo_root)
    cell = bench.cell(workload)
    config, traffic, limits = bench.config(cell), bench.traffic(cell), bench.limits(cell)
    loop = LOOPS[traffic["loop"]](config, traffic, device, seed)
    phases = dict(phases or {})
    for phase in ("prepare", "build", "warm"):
        t = time.perf_counter()
        getattr(loop, phase)()
        phases[phase] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    rec = loop.window(seconds, trace)
    dev = device_block(device, cell["chips"])
    work = loop.work(rec)
    e2e_spec = bench.end_to_end(cell)
    e2e = dict(loop.end_to_end(rec), setup_s=setup_s)
    loop.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    readings = loop.check()
    checks = compare(readings, limits)
    metrics = {}
    breakdown = None
    if not trace:
        for m in e2e_spec:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        prof = rec["profile"]
        prof.finish()
        ctx = TraceContext(config, traffic, work, rec["spans"], prof)
        for m in bench.per_layer(cell, e2e_spec):
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = prof.busy_s, prof.window_s
        breakdown = prof.breakdown()
    correct = (rec["failed"] == 0 and all(c["ok"] for c in checks.values())
               and all(m["name"] in metrics for m in (e2e_spec if not trace else [])))
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_phases"] = phases
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r}){'' if c['ok'] else ' FAILED'}"
             for k, c in checks.items()]
    return result, lines, readings


def cache_dirs(repo_root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = Path(repo_root) / "build" / "portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
