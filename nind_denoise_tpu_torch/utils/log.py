"""stdout + logfile tee and per-stage wall-clock timers: copies of
``Printer`` and ``StageTimers`` from ``nind_denoise_tpu/utils/log.py``.
The trainer tees its log through ``Printer``; the CLIs print
``StageTimers.summary()`` under ``-v``."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


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
