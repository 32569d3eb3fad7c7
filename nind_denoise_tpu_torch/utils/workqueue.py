"""Consumer loop of the serving dispatcher (``pipeline/serve.py``).

A copy of ``nind_denoise_tpu/utils/workqueue.py`` ``consume``. One queue
holds two job kinds: generic ``(fn, done)`` 2-tuples and typed
``("den", key, payload, done)`` 4-tuples. Consecutive same-key typed jobs
coalesce into one group (continuous batching over
``TileEngine.denoise_many``); FIFO order around generic jobs, such as a
checkpoint-rollover swap, is kept exactly, and a sentinel seen mid-drain
still lets the group run.
"""

from __future__ import annotations

import queue as _queue
from typing import Callable


def consume(q: "_queue.Queue", closing, run_one: Callable,
            run_group: Callable, limit_fn: Callable[[], int],
            get_timeout: float = 0.5) -> None:
    """Run jobs from ``q`` until a ``None`` sentinel, or until ``closing``
    is set and the queue stays empty past ``get_timeout``.

    * generic 2-tuple job -> ``run_one(job)``
    * typed 4-tuple job ``("den", key, payload, done)`` -> drain
      consecutive same-key typed successors (up to ``limit_fn()``, queried
      with the first job already in hand) into one list ->
      ``run_group(group)``. A non-matching job stops the drain and runs
      NEXT on this consumer — it was queued after every group member, so
      FIFO order is preserved exactly. A sentinel seen mid-drain stops
      this consumer after the group completes.
    """
    held = None  # job popped while draining; runs next, in order
    while True:
        if held is not None:
            job, held = held, None
        else:
            try:
                job = q.get(timeout=get_timeout)
            except _queue.Empty:
                if closing.is_set():
                    return
                continue
        if job is None:
            return
        if len(job) == 2:
            run_one(job)
            continue
        group = [job]
        saw_sentinel = False
        limit = limit_fn()
        while len(group) < limit:
            try:
                nxt = q.get_nowait()
            except _queue.Empty:
                break
            if nxt is None:
                saw_sentinel = True
                break
            if len(nxt) == 4 and nxt[1] == job[1]:
                group.append(nxt)
            else:
                held = nxt
                break
        run_group(group)
        if saw_sentinel:
            return
