"""Per-stage wall-clock timers: a copy of ``StageTimers`` from
``nind_denoise_tpu/utils/log.py``. The CLIs print ``summary()`` under
``-v``."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


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
