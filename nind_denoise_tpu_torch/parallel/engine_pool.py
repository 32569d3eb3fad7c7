"""Request-level device parallelism: one engine replica a device, one
shared bounded queue, no collectives.

Counterpart of ``nind_denoise_tpu/parallel/engine_pool.py`` ``EnginePool``.
Each request runs start to finish on one device (upload, tile forwards, RL,
quantize, download), so N devices serve N requests at single-device speed.
Under backlogs deeper than the device count, typed submissions
(``submit_denoise``) coalesce a worker at a time: consecutive
same-(shape, dtype, scale) requests run as one engine dispatch
(``AdaptiveEngine.denoise_many``), bounded by the worker's fair share of
the backlog so that sibling devices never starve.

Each worker thread owns its device: it makes the device current
(``torch.cuda.set_device``) and runs every job on a stream of its own,
synchronized before the job's waiter is released, so a result handed back
is complete and two replicas on one card still overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..engine.tile_engine import AdaptiveEngine
from ..utils import workqueue
from . import mesh


class EnginePool:
    """N device-pinned ``AdaptiveEngine`` replicas consuming one bounded
    queue.

    ``submit(fn)`` blocks until some worker has run ``fn(worker_engine)``
    and returns its result; with ``block=False`` a full queue raises
    ``queue.Full`` at once (the server answers 503). Jobs receive the
    worker's engine, so their post-ops run on the device that denoised.
    ``devices``: a list (a repeated device gets one replica an entry), or
    None for every visible GPU."""

    # max typed requests one worker coalesces into a single engine dispatch
    MAX_COALESCE = 8

    def __init__(self, network: str, model, devices=None, *,
                 cs: Optional[int] = None, ucs: Optional[int] = None,
                 batch_size: int = 8, compute_dtype: str = "bfloat16",
                 precision: str = "default", max_subpixels: Optional[int] = None,
                 max_pending: int = 0):
        devices = mesh.make_devices(devices)
        # the one source of replica config: __init__ and reload() both build
        # from it, so boot-time and rolled-over replicas cannot drift
        self._build_kw = dict(cs=cs, ucs=ucs, batch_size=batch_size,
                              compute_dtype=compute_dtype, precision=precision,
                              max_subpixels=max_subpixels)
        self._network = network
        # built here, serially, so that a constructor error surfaces at once
        self._replicas: List[AdaptiveEngine] = [
            AdaptiveEngine(network, model, device=d, **self._build_kw) for d in devices]
        self.devices = devices
        # a name a replica: the device, and the replica's index where a
        # device is listed more than once
        self.names = [str(d) if devices.count(d) == 1 else f"{d}#{i}"
                      for i, d in enumerate(devices)]
        self.cs, self.ucs = self._replicas[0].cs, self._replicas[0].ucs
        self._streams = mesh.streams_for(devices)
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._closing = threading.Event()
        self._reload_lock = threading.Lock()
        self.coalesced = 0  # requests that rode a shared dispatch
        self._coalesce_lock = threading.Lock()
        # typed jobs submitted and not yet claimed by a group: the fair
        # share's numerator (not q.qsize(); see _run)
        self._typed_pending = 0
        # workers look their replica up per job, so reload() can swap them
        self._workers = [threading.Thread(target=self._run, args=(i,), daemon=True)
                         for i in range(len(self._replicas))]
        for t in self._workers:
            t.start()

    # -- worker loop -----------------------------------------------------------

    def _run(self, idx: int):
        """One device's consumer of generic and typed jobs
        (``utils/workqueue.consume``). Greedy draining would starve the
        siblings, so a worker drains at most its fair share of the backlog.

        The share reads ``_typed_pending``, not ``q.qsize()``: when N parked
        workers wake together over a backlog of 2N, each pops one job before
        any computes its share, so the queue then holds about N and a
        qsize-based share is 1: every group would be a singleton. Counting
        the jobs submitted and not yet claimed, every worker sees 2N and
        takes 2, and at most N of the 2N are in hand, so the first worker to
        drain finds a partner."""
        if self.devices[idx].type == "cuda":
            torch.cuda.set_device(self.devices[idx])

        def fair_share() -> int:
            with self._coalesce_lock:
                pending = self._typed_pending
            return min(self.MAX_COALESCE, max(1, -(-pending // len(self._workers))))

        workqueue.consume(self._q, self._closing,
                          lambda job: self._run_one(idx, job),
                          lambda group: self._run_group(idx, group),
                          fair_share, get_timeout=0.25)

    def _on_device(self, idx: int, fn: Callable):
        """``fn()`` with the worker's device and stream current, the stream
        synchronized before it returns."""
        with mesh.on_device(self.devices[idx], self._streams[idx]):
            out = fn()
            if self._streams[idx] is not None:
                self._streams[idx].synchronize()
            return out

    @staticmethod
    def _fail(done, e: BaseException) -> None:
        # the waiter must always be released
        done["error"] = (e if isinstance(e, Exception) else
                         RuntimeError(f"fatal pool error: {e!r}"))

    def _run_one(self, idx: int, job):
        fn, done = job
        try:
            done["result"] = self._on_device(idx, lambda: fn(self._replicas[idx]))
        except BaseException as e:  # noqa: BLE001 — see _fail
            self._fail(done, e)
        finally:
            done["event"].set()

    def _run_group(self, idx: int, group):
        """One coalesced dispatch for N same-key typed requests on this
        worker's replica, then each request's ``post`` on the same device."""
        import time

        replica = self._replicas[idx]
        payloads = [j[2] for j in group]
        dones = [j[3] for j in group]
        with self._coalesce_lock:  # these jobs are now claimed, not pending
            self._typed_pending -= len(group)
            for d in dones:
                d["claimed"] = True
        t0 = time.perf_counter()
        try:
            outs = self._on_device(idx, lambda: replica.denoise_many(
                [p["raw"] for p in payloads], payloads[0]["scale"], out_dtype="device"))
        except BaseException as e:  # noqa: BLE001 — see _fail
            for d in dones:
                self._fail(d, e)
                d["event"].set()
            return
        meta = {"device": self.names[idx], "group": len(group),
                "elapsed": time.perf_counter() - t0}
        if len(group) > 1:
            with self._coalesce_lock:
                self.coalesced += len(group)
        for p, out01, d in zip(payloads, outs, dones):
            try:
                d["result"] = self._on_device(idx, lambda: p["post"](replica, out01, meta))
            except BaseException as e:  # noqa: BLE001 — see _fail
                self._fail(d, e)
            finally:
                d["event"].set()

    # -- checkpoint rollover ----------------------------------------------------

    def reload(self, model, quiesce_timeout: float = 3600.0) -> None:
        """Swap every replica to ``model`` (same network and config) as a
        drain-and-swap rollover: N jobs park the N workers at a barrier (a
        worker runs one job at a time, so the barrier releasing proves every
        worker idle), then each worker builds its own replica on its own
        thread. Requests queued behind the rollover run on the new replicas.

        All or nothing: the builds go to a side table, a second barrier
        proves every build finished, and only if all succeeded does any
        worker swap. A failed build leaves every replica on the old
        checkpoint, and reload raises with the build error chained. Raises
        ``BrokenBarrierError`` if the pool cannot quiesce within
        ``quiesce_timeout`` (the pool keeps serving the old checkpoint)."""
        n = len(self._workers)
        barrier = threading.Barrier(n)  # cyclic: reused for phase 2
        built: List[Optional[AdaptiveEngine]] = [None] * n
        errors: List[BaseException] = []
        err_lock = threading.Lock()

        def rebuild(replica):
            try:
                barrier.wait(timeout=quiesce_timeout)
            except threading.BrokenBarrierError:
                barrier.abort()  # release any workers still parked
                raise
            # the worker is known by the replica it holds (distinct objects;
            # the barrier proves no swap happened yet)
            i = next(k for k, r in enumerate(self._replicas) if r is replica)
            try:
                built[i] = AdaptiveEngine(self._network, model, device=replica.device,
                                          **self._build_kw)
            except BaseException as e:  # noqa: BLE001 — must reach phase 2
                with err_lock:
                    errors.append(e)
            try:
                barrier.wait(timeout=quiesce_timeout)
            except threading.BrokenBarrierError:
                barrier.abort()
                raise
            if not errors:
                self._replicas[i] = built[i]
            return i

        # serialize rollovers: two interleaved barrier sets could park the
        # workers across different barriers and neither would release
        with self._reload_lock:
            done = self.map(range(n), lambda w, _i: rebuild(w))
        assert sorted(done) == list(range(n))
        if errors:
            raise RuntimeError("checkpoint rollover aborted: a replica rebuild failed; "
                               "every device keeps serving the previous checkpoint") \
                from errors[0]

    # -- submission -------------------------------------------------------------

    def _enqueue_and_wait(self, item, done, block: bool):
        if self._closing.is_set():
            raise RuntimeError("EnginePool is closed")
        if block:
            self._q.put(item)
        else:
            self._q.put_nowait(item)
        # liveness loop, not a bare wait: close() racing this submit can
        # retire every worker between the flag check and the put
        while not done["event"].wait(timeout=0.25):
            if self._closing.is_set() and not any(t.is_alive() for t in self._workers):
                raise RuntimeError("EnginePool closed while the job was pending")
        if "error" in done:
            raise done["error"]
        return done["result"]

    def submit(self, fn: Callable, block: bool = True):
        """Run ``fn(worker_engine)`` on some device's worker and return its
        result (re-raising its exception); ``block=False`` raises
        ``queue.Full`` instead of waiting for queue space."""
        done = {"event": threading.Event()}
        return self._enqueue_and_wait((fn, done), done, block)

    def submit_denoise(self, raw: np.ndarray, scale: float, post: Callable,
                       block: bool = True):
        """Typed submission a worker may coalesce with consecutive queued
        requests of the same (shape, dtype, scale) into one dispatch.
        ``post(engine, out01_device, meta)`` runs for each request on the
        owning worker afterwards (``meta`` = {device, group, elapsed}); its
        return value is this call's result."""
        done = {"event": threading.Event()}
        key = (raw.shape, raw.dtype.str, float(scale))
        payload = {"raw": raw, "scale": scale, "post": post}
        # counted as outstanding before it can be popped (see _run); rolled
        # back below if the enqueue fails or close() drops it unclaimed
        with self._coalesce_lock:
            self._typed_pending += 1
        try:
            return self._enqueue_and_wait(("den", key, payload, done), done, block)
        except BaseException:
            with self._coalesce_lock:
                if not done.get("claimed"):
                    self._typed_pending -= 1
                    done["claimed"] = True
            raise

    def denoise_raw(self, raw_hwc: np.ndarray, scale: float, out_dtype: str = "float32"):
        """Blocking convenience: tiling-adaptive denoise on some device."""
        return self.submit(lambda w: w.denoise_raw(raw_hwc, scale, out_dtype=out_dtype))

    def map(self, items, fn: Callable):
        """``fn(worker_engine, item)`` for every item across the pool, in item
        order. The caller's threads feed the queue (one an item in flight),
        so a bounded queue still pushes back."""
        import concurrent.futures as fut

        with fut.ThreadPoolExecutor(max_workers=max(1, len(self._workers))) as feeders:
            futures = [feeders.submit(self.submit, lambda w, it=item: fn(w, it))
                       for item in items]
            return [f.result() for f in futures]

    def close(self):
        self._closing.set()
        for _ in self._workers:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                break
        for t in self._workers:
            t.join(timeout=5.0)
        # release waiters whose jobs the retired workers will never run
        while True:
            try:
                job = self._q.get_nowait()
            except queue.Empty:
                return
            if job is not None:
                # the done dict is the last element of both job layouts
                done = job[-1]
                done["error"] = RuntimeError("EnginePool closed before the job ran")
                done["event"].set()
