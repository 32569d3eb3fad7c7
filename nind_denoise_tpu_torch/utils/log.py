"""stdout + logfile tee, per-stage wall-clock timers and the profiler
capture: the counterparts of ``Printer``, ``StageTimers`` and
``maybe_profile`` in ``nind_denoise_tpu/utils/log.py``. The trainer tees
its log through ``Printer``; the CLIs print ``StageTimers.summary()``
under ``-v``; ``denoise_image_cli --trace_dir`` runs under
``maybe_profile``."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class Printer:
    def __init__(self, tostdout: bool = True, tofile: bool = True, file_path: str = "log"):
        self.tostdout = tostdout
        self.tofile = tofile
        self.file_path = file_path

    def print(self, msg) -> None:
        if self.tostdout:
            print(msg, flush=True)
        if self.tofile:
            try:
                with open(self.file_path, "a") as f:
                    f.write(str(msg) + "\n")
            except OSError as e:
                print(f"Warning: could not write to log: {e}")


class StageTimers:
    """Accumulating named wall-clock timers (decode/load/denoise/...)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        parts = [f"{k}: {v:.3f}s/{self.counts[k]}x" for k, v in sorted(self.totals.items())]
        return ", ".join(parts)


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """Within, where ``trace_dir`` is given: ``torch.profiler`` records the
    host's operators and, where CUDA is present, the card's kernels and
    copies; on a clean exit it writes a
    Chrome trace (``chrome://tracing`` or Perfetto) into ``trace_dir``,
    which it creates, as ``<host>_<pid>.<ms>.pt.trace.json``. The traced
    work computes what it computes without the trace."""
    if not trace_dir:
        yield
        return
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    fpath = os.path.join(trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                                    f"{int(time.time() * 1e3)}.pt.trace.json")
    prof.export_chrome_trace(fpath)
    print(f"Profiler trace written to {fpath}")
