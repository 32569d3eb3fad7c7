"""denoise-serve — the persistent HTTP serving daemon, on one or more GPUs.

Counterpart of ``nind_denoise_tpu/pipeline/serve.py``. The checkpoint
loads once and the engines stay warm across requests. ``--parallel``
picks the multi-device strategy over ``--devices`` (``parallel/mesh``;
absent: every visible GPU): ``auto`` shards when there is more than one
device, ``single`` runs one, ``shard`` splits every request into row bands
over all devices (``parallel/sharded_engine``, lowest latency; RL on the
first device), ``images`` runs one request a device through
``parallel/engine_pool`` (highest throughput under concurrent load; its
workers coalesce as the dispatcher below does, and ``/stats`` counts
requests ``per_device``). In single mode:

* stdlib ``http.server``; handler threads decode the request body and
  enqueue it, and ONE dispatcher thread runs all device work from a
  bounded queue (``utils/workqueue.consume``). A full queue answers 503.
* Continuous batching: consecutive queued requests with the same
  (shape, dtype, scale) coalesce into one engine dispatch
  (``AdaptiveEngine.denoise_many``: tile batches fill across image
  boundaries). Within a group, requests with the same RL parameters share
  one batched RL dispatch and one fetch (``_post_u8_batch``). On the CPU
  every response equals its serial result bit for bit; on CUDA cuDNN can
  round a tile differently in another batch (its size, and in some layers
  the tile's slot), so a coalesced response is within 1 LSB of its serial
  one. A queued reload
  is never reordered.

Endpoints:

* ``GET  /healthz`` -> {"status": "ok", "devices", "mode", "cs", "ucs"}
* ``GET  /stats``   -> counters, ``latency_ms`` (p50/p95/p99/mean/max over
  the last 1024 requests, decode -> fetched result), ``stage_s``,
  ``group_sizes``, ``coalesced_requests``, ``rejected_busy``
* ``POST /denoise`` -> body: an encoded image (png/jpg/tiff); query:
  ``output`` (jpg|png|tiff, default jpg), ``quality`` (default 90), ``rl``
  (1|0, default 1), ``sigma``, ``iterations``, ``psf``; returns the
  encoded result
* ``POST /reload?model_path=...`` -> hot checkpoint rollover

``--compute_dtype int8|int8_static`` serves the quantized forward
(kernel P1); ``int8_static`` recalibrates on each request's image and
never coalesces (``AdaptiveEngine``). ``psf=gmic_fast`` runs RL with the
Deriche IIR (kernel P2).

    python -m nind_denoise_tpu_torch.pipeline.serve --model_path ckpt.npz \
        [--device cpu] --port 8601
    curl -X POST --data-binary @noisy.png \
        'http://localhost:8601/denoise?output=png' > out.png
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import cv2
import numpy as np
import torch

from ..engine.tile_engine import AdaptiveEngine
from ..models import params_io
from ..ops import rl_deblur
from ..parallel import mesh
from ..utils import workqueue


class ServiceBusy(RuntimeError):
    """Request queue at capacity — mapped to HTTP 503 (shed, don't buffer)."""


def _check_psf(rl: bool, psf: str) -> None:
    if not rl:
        return  # the psf only shapes the RL stage
    if psf not in ("gaussian", "gmic_fast"):
        raise ValueError(f"unknown psf {psf!r}")


class DenoiseService:
    """Warm engine(s) + dispatch; thread-safe submit().

    ``network``: UtNet or UNet. ``devices``: a count or a device list
    (``parallel/mesh.make_devices``; None: every visible GPU, or the CPU
    under ``device="cpu"``). ``parallel``: 'auto' (shard when >1 device),
    'shard' (row bands of every request over all devices), 'images' (one
    request a device, ``EnginePool``) or 'single' (one device)."""

    # max requests per coalesced group: bounds the stacked band's device
    # memory and the latency a request adds to those coalesced behind it
    MAX_COALESCE = 8
    # sliding-window size for the latency percentiles in /stats
    LATENCY_WINDOW = 1024

    def __init__(self, network: str, model_path: str, cs=None, ucs=None,
                 activation: str = "PReLU", batch_size: int = 8,
                 compute_dtype: str = "bfloat16", device=None,
                 max_pending: int = 8, parallel: str = "auto", devices=None):
        if parallel not in ("auto", "single", "shard", "images"):
            raise ValueError(f"unknown parallel mode {parallel!r}")
        self.devices = mesh.make_devices(devices, device)
        self.ndev = len(self.devices)
        if parallel == "auto":
            parallel = "shard" if self.ndev > 1 else "single"
        if parallel != "images" and self.ndev <= 1:
            parallel = "single"
        self.mode = parallel
        if parallel == "single":
            self.devices, self.ndev = self.devices[:1], 1
        self.device = self.devices[0]
        self._network, self._activation = network, activation
        self._batch_size, self._compute_dtype = batch_size, compute_dtype
        self.stats = {"requests": 0, "errors": 0, "megapixels": 0.0,
                      "busy_s": 0.0, "reloads": 0, "per_device": {},
                      "coalesced_requests": 0,
                      # queue-full 503s, kept out of latency_ms
                      "rejected_busy": 0,
                      # coalesced-dispatch size histogram {size: count}
                      "group_sizes": {},
                      # cumulative wall seconds per stage: decode = body ->
                      # RGB array, queue = enqueue -> dispatcher pickup,
                      # denoise = engine dispatch, post = RL/quantize +
                      # fetch, encode = u8 -> response bytes
                      "stage_s": {"decode": 0.0, "queue": 0.0, "denoise": 0.0,
                                  "post": 0.0, "encode": 0.0}}
        self._stats_lock = threading.Lock()
        self._latencies = collections.deque(maxlen=self.LATENCY_WINDOW)
        model = params_io.load_generator(model_path, network, activation)
        self._pool = self._q = None
        self._closing = threading.Event()
        if parallel == "images":
            from ..parallel.engine_pool import EnginePool

            self._pool = EnginePool(network, model, self.devices, cs=cs, ucs=ucs,
                                    batch_size=batch_size, compute_dtype=compute_dtype,
                                    max_pending=max_pending)
            self.cs, self.ucs = self._pool.cs, self._pool.ucs
            return
        self._adaptive = self._build_engine(model, cs, ucs)
        self.cs, self.ucs = self._adaptive.cs, self._adaptive.ucs
        # bounded queue = backpressure: each queued job holds a decoded
        # image; beyond the bound submit() raises ServiceBusy (-> 503)
        self._q = queue.Queue(maxsize=max_pending)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _build_engine(self, model, cs, ucs):
        """Single mode: one ``AdaptiveEngine``; shard mode:
        ``AdaptiveSharded`` (row bands over every device for each adapted
        tile size, the first device's padded forward below the minimum
        tiling)."""
        if self.mode == "shard":
            from ..parallel.sharded_engine import AdaptiveSharded

            return AdaptiveSharded(self._network, model, self.devices, cs=cs, ucs=ucs,
                                   batch_size=self._batch_size,
                                   compute_dtype=self._compute_dtype)
        return AdaptiveEngine(
            self._network, model, cs=cs, ucs=ucs, batch_size=self._batch_size,
            compute_dtype=self._compute_dtype, device=self.device)

    # -- dispatcher ----------------------------------------------------------

    def _run(self):
        workqueue.consume(self._q, self._closing, self._run_one,
                          self._run_group, lambda: self.MAX_COALESCE)

    @staticmethod
    def _fail(done, e: BaseException) -> None:
        # the waiter must always be released: a BaseException escaping here
        # would hang this request and every later one
        done["error"] = (e if isinstance(e, Exception) else
                         RuntimeError(f"fatal dispatcher error: {e!r}"))

    def _run_one(self, job):
        fn, done = job
        try:
            done["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — see _fail
            self._fail(done, e)
        finally:
            done["event"].set()

    def _run_group(self, group):
        """One coalesced denoise for N queued same-key requests, then one
        post per sub-group of requests that share RL parameters."""
        payloads = [j[2] for j in group]
        dones = [j[3] for j in group]
        t0 = time.perf_counter()
        queue_s = sum(t0 - p["t_enq"] for p in payloads)
        try:
            outs = self._adaptive.denoise_many(
                [p["raw"] for p in payloads], payloads[0]["scale"],
                out_dtype="device")
        except BaseException as e:  # noqa: BLE001 — see _fail
            for d in dones:
                self._fail(d, e)
                d["event"].set()
            return
        t1 = time.perf_counter()
        mp = 0.0
        subgroups: dict = {}
        for idx, p in enumerate(payloads):
            key = (bool(p["rl"]), float(p["sigma"]), int(p["iterations"]), p["psf"])
            subgroups.setdefault(key, []).append(idx)
        for idxs in subgroups.values():
            try:
                if len(idxs) == 1:
                    res = [self._post_u8(outs[idxs[0]], payloads[idxs[0]])]
                else:
                    res = self._post_u8_batch([outs[i] for i in idxs],
                                              payloads[idxs[0]])
            except BaseException as e:  # noqa: BLE001 — see _fail
                for i in idxs:
                    self._fail(dones[i], e)
                    dones[i]["event"].set()
                continue
            for i, u8 in zip(idxs, res):
                dones[i]["result"] = u8
                h, w = payloads[i]["raw"].shape[:2]
                mp += h * w / 1e6
                dones[i]["event"].set()
        t2 = time.perf_counter()
        with self._stats_lock:
            self.stats["busy_s"] += t2 - t0
            self.stats["megapixels"] += mp
            st = self.stats["stage_s"]
            st["queue"] += queue_s
            st["denoise"] += t1 - t0
            st["post"] += t2 - t1
            gs = self.stats["group_sizes"]
            gs[str(len(group))] = gs.get(str(len(group)), 0) + 1
            if len(group) > 1:
                self.stats["coalesced_requests"] += len(group)

    @staticmethod
    def _to_u8(out01: torch.Tensor, p) -> torch.Tensor:
        """RL deblur + gmic quantize, or the plain quantize, on the device."""
        if p["rl"]:
            return rl_deblur.rl_to_u8_device(out01, float(p["sigma"]),
                                             int(p["iterations"]), psf=p["psf"])
        return torch.round(torch.clamp(out01, 0, 1) * 255).to(torch.uint8)

    @classmethod
    def _post_u8_batch(cls, outs01, p) -> list:
        """Post for a sub-group with shared RL parameters: stack on the
        device, one RL dispatch over the batch (planes are independent, so
        each member equals its single run bit for bit), one fetch."""
        return list(cls._to_u8(torch.stack(outs01), p).cpu().numpy())

    @classmethod
    def _post_u8(cls, out01, p) -> np.ndarray:
        """Post for one request: device fp32 HWC -> host uint8 HWC."""
        return cls._to_u8(out01, p).cpu().numpy()

    def _enqueue_and_wait(self, item, done):
        if self._closing.is_set():
            raise ServiceBusy("service is shutting down")
        try:
            self._q.put_nowait(item)
        except queue.Full:
            raise ServiceBusy(
                f"request queue full ({self._q.maxsize} pending)") from None
        # liveness loop, not a bare wait: close() racing this submit can
        # retire the dispatcher between the flag check and the put
        while not done["event"].wait(timeout=0.5):
            if self._closing.is_set() and not self._worker.is_alive():
                raise ServiceBusy("service closed before the request ran")
        if "error" in done:
            raise done["error"]
        return done["result"]

    def submit(self, fn):
        """Run ``fn()`` on the dispatcher thread, in queue order."""
        done = {"event": threading.Event()}
        return self._enqueue_and_wait((fn, done), done)

    def submit_denoise(self, raw: np.ndarray, scale: float, rl: bool,
                       sigma: float, iterations: int, psf: str,
                       t_enq: float | None = None) -> np.ndarray:
        """Typed submission: the dispatcher may coalesce consecutive queued
        requests with the same (shape, dtype, scale) into one dispatch; the
        RL parameters apply per request after the shared denoise."""
        done = {"event": threading.Event()}
        key = (raw.shape, raw.dtype.str, float(scale))
        payload = {"raw": raw, "scale": scale, "rl": rl, "sigma": sigma,
                   "iterations": iterations, "psf": psf,
                   "t_enq": time.perf_counter() if t_enq is None else t_enq}
        return self._enqueue_and_wait(("den", key, payload, done), done)

    def bump(self, key: str) -> None:
        with self._stats_lock:
            self.stats[key] += 1

    def _stage(self, key: str, dt: float) -> None:
        with self._stats_lock:
            self.stats["stage_s"][key] += dt

    def snapshot_stats(self) -> dict:
        with self._stats_lock:
            s = dict(self.stats)
            s["per_device"] = dict(s["per_device"])
            s["group_sizes"] = dict(s["group_sizes"])
            s["stage_s"] = {k: round(v, 6) for k, v in s["stage_s"].items()}
            lat = np.asarray(self._latencies, np.float64)
        if lat.size:
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            s["latency_ms"] = {"window": int(lat.size),
                               "mean": round(float(lat.mean()) * 1e3, 2),
                               "p50": round(float(p50) * 1e3, 2),
                               "p95": round(float(p95) * 1e3, 2),
                               "p99": round(float(p99) * 1e3, 2),
                               "max": round(float(lat.max()) * 1e3, 2)}
        else:
            # always present: a dashboard scraping an idle daemon reads
            # null percentiles over window 0
            s["latency_ms"] = {"window": 0, "mean": None, "p50": None,
                               "p95": None, "p99": None, "max": None}
        return s

    def prewarm(self, height: int, width: int, dtype: str = "uint16",
                rl: bool = True, sigma: float = 1.0, iterations: int = 10,
                psf: str = "gaussian") -> dict:
        """Run each group size 1..MAX_COALESCE once at (height, width) on
        the dispatcher thread (images mode: on every pool worker; shard mode
        has no groups), so that first traffic does not pay the libraries'
        first-call set-up. Returns {"mode", "sizes", "seconds"}."""
        t0 = time.perf_counter()
        np_dtype = np.dtype(dtype)
        scale = {np.uint8: 255.0, np.uint16: 65535.0}.get(np_dtype.type, 1.0)
        rl_p = {"rl": rl, "sigma": sigma, "iterations": iterations, "psf": psf}
        sizes = list(range(1, self.MAX_COALESCE + 1))

        def warm(engine):
            raw = np.zeros((height, width, 3), np_dtype)
            for n in sizes:
                outs = engine.denoise_many([raw] * n, scale, out_dtype="device")
                if n == 1:
                    self._post_u8(outs[0], rl_p)
                else:
                    self._post_u8_batch(outs, rl_p)
            return True

        if self.mode == "images":  # every replica on its own worker
            self._pool.map(range(len(self._pool.devices)), lambda w, _i: warm(w))
        elif self.mode == "single":
            self.submit(lambda: warm(self._adaptive))
        return {"mode": self.mode, "sizes": sizes,
                "seconds": round(time.perf_counter() - t0, 2)}

    def reload(self, model_path: str) -> dict:
        """Hot checkpoint rollover: load the new weights on the caller's
        thread, build the new engine and swap it in on the dispatcher thread,
        between requests. Requests queued before the reload finish on the
        old weights, later ones run the new; none is dropped."""
        model = params_io.load_generator(model_path, self._network, self._activation)
        if self.mode == "images":
            self._pool.reload(model)
        else:
            def swap():
                # a failed build raises before the assignment: the service
                # stays on the previous engine
                self._adaptive = self._build_engine(model, self.cs, self.ucs)
                return True

            self.submit(swap)
        with self._stats_lock:
            self.stats["reloads"] += 1
        return {"status": "reloaded", "model_path": model_path, "mode": self.mode}

    def close(self):
        """Retire the dispatcher without blocking: the flag lets it exit
        once the queue drains even when the sentinel does not fit."""
        if self._pool is not None:
            self._pool.close()
            return
        self._closing.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass

    # -- request body --------------------------------------------------------

    def denoise_bytes(self, data: bytes, output: str = "jpg",
                      quality: int = 90, rl: bool = True, sigma: float = 1.0,
                      iterations: int = 10, psf: str = "gaussian") -> bytes:
        # reject bad parameters before the denoise spends device time
        if output not in ("jpg", "jpeg", "png", "tiff"):
            raise ValueError(f"unsupported output format {output!r}")
        _check_psf(rl, psf)
        t_req = time.perf_counter()
        arr = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_COLOR + cv2.IMREAD_ANYDEPTH)
        if arr is None:
            raise ValueError("could not decode request body as an image")
        scale = {np.uint8: 255.0, np.uint16: 65535.0}.get(arr.dtype.type, 1.0)
        raw = np.ascontiguousarray(arr[..., ::-1])
        t_dec = time.perf_counter()
        self._stage("decode", t_dec - t_req)
        try:
            u8 = self._dispatch(raw, scale, {"rl": rl, "sigma": float(sigma),
                                             "iterations": int(iterations), "psf": psf,
                                             "t_enq": t_dec})
        except ServiceBusy:
            # instant 503s stay out of the latency window, or a flood of
            # them would drag p50/p95 down exactly under overload
            self.bump("rejected_busy")
            raise
        except BaseException:
            # an admitted request that failed after its queue wait counts
            with self._stats_lock:
                self._latencies.append(time.perf_counter() - t_req)
            raise
        with self._stats_lock:
            self._latencies.append(time.perf_counter() - t_req)
        t_enc = time.perf_counter()
        bgr = u8[..., ::-1]
        if output in ("jpg", "jpeg"):
            ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
        else:
            ok, buf = cv2.imencode("." + output, bgr)
        if not ok:
            raise RuntimeError(f"encode to {output} failed")
        out = buf.tobytes()
        self._stage("encode", time.perf_counter() - t_enc)
        return out

    def _dispatch(self, raw: np.ndarray, scale: float, p: dict) -> np.ndarray:
        """Route one decoded request to the mode's engines; the uint8 result."""
        if self.mode == "single":
            # typed: concurrent same-shape requests coalesce (_run_group)
            return self.submit_denoise(raw, scale, p["rl"], p["sigma"], p["iterations"],
                                       p["psf"], t_enq=p["t_enq"])
        mp = raw.shape[0] * raw.shape[1] / 1e6
        if self.mode == "images":
            def post(engine, out01, meta):
                # on the worker that denoised; the group's time is shared out
                t0 = time.perf_counter()
                u8 = self._post_u8(out01, p)
                t1 = time.perf_counter()
                with self._stats_lock:
                    self.stats["busy_s"] += meta["elapsed"] / meta["group"] + t1 - t0
                    self.stats["megapixels"] += mp
                    st = self.stats["stage_s"]
                    st["queue"] += max(0.0, t0 - p["t_enq"] - meta["elapsed"])
                    st["denoise"] += meta["elapsed"] / meta["group"]
                    st["post"] += t1 - t0
                    per = self.stats["per_device"]
                    per[meta["device"]] = per.get(meta["device"], 0) + 1
                    if meta["group"] > 1:
                        self.stats["coalesced_requests"] += 1
                return u8

            try:
                return self._pool.submit_denoise(raw, scale, post, block=False)
            except queue.Full:
                raise ServiceBusy("request queue full") from None

        def work():  # shard mode, on the dispatcher thread
            t0 = time.perf_counter()
            out01 = self._adaptive.denoise_raw(raw, scale, out_dtype="device")
            t1 = time.perf_counter()
            u8 = self._post_u8(out01, p)
            t2 = time.perf_counter()
            with self._stats_lock:
                self.stats["busy_s"] += t2 - t0
                self.stats["megapixels"] += mp
                st = self.stats["stage_s"]
                st["queue"] += t0 - p["t_enq"]
                st["denoise"] += t1 - t0
                st["post"] += t2 - t1
            return u8

        return self.submit(work)


def make_handler(svc: DenoiseService):
    class Handler(BaseHTTPRequestHandler):
        MAX_BODY = 512 * 1024 * 1024  # 512 MB: beyond any supported image

        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok", "devices": svc.ndev,
                                 "mode": svc.mode, "cs": svc.cs, "ucs": svc.ucs})
            elif path == "/stats":
                self._json(200, svc.snapshot_stats())
            else:
                self._json(404, {"error": "unknown endpoint"})

        def _do_reload(self, parsed):
            """``POST /reload?model_path=...``: the path names a checkpoint
            on the server's disk; no body."""
            q = urllib.parse.parse_qs(parsed.query)
            model_path = q.get("model_path", [None])[0]
            if not model_path:
                return self._json(400, {"error": "model_path query param required"})
            # drain any body so the connection stays usable
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            if 0 < length <= self.MAX_BODY:
                self.rfile.read(length)
            try:
                return self._json(200, svc.reload(model_path))
            except Exception as e:
                svc.bump("errors")
                code = (503 if isinstance(e, ServiceBusy)
                        else 400 if isinstance(e, (ValueError, OSError)) else 500)
                return self._json(code, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/reload":
                return self._do_reload(parsed)
            if parsed.path != "/denoise":
                return self._json(404, {"error": "unknown endpoint"})
            q = urllib.parse.parse_qs(parsed.query)
            get = lambda k, d: q.get(k, [d])[0]  # noqa: E731
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                return self._json(400, {"error": "bad Content-Length header"})
            if length < 0:
                return self._json(400, {"error": "bad Content-Length header"})
            if length == 0:  # absent or zero (chunked uploads unsupported)
                return self._json(411, {"error": "Content-Length required"})
            if length > self.MAX_BODY:
                return self._json(413, {"error": f"body size {length} "
                                                 f"exceeds {self.MAX_BODY}"})
            data = self.rfile.read(length)
            svc.bump("requests")
            try:
                out = svc.denoise_bytes(
                    data, output=get("output", "jpg"),
                    quality=int(get("quality", "90")),
                    rl=get("rl", "1") not in ("0", "false"),
                    sigma=float(get("sigma", "1")),
                    iterations=int(get("iterations", "10")),
                    psf=get("psf", "gaussian"))
            except Exception as e:
                svc.bump("errors")
                # bad image or parameters -> 400; queue full -> 503
                # (retryable); anything else -> 500
                code = (503 if isinstance(e, ServiceBusy)
                        else 400 if isinstance(e, ValueError) else 500)
                return self._json(code, {"error": f"{type(e).__name__}: {e}"})
            ctype = {"jpg": "image/jpeg", "jpeg": "image/jpeg",
                     "png": "image/png", "tiff": "image/tiff"}[get("output", "jpg")]
            self._send(200, out, ctype)

    return Handler


def serve(svc: DenoiseService, host: str = "127.0.0.1", port: int = 8601):
    return ThreadingHTTPServer((host, port), make_handler(svc))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--network", default="UtNet")
    ap.add_argument("--cs", type=int)
    ap.add_argument("--ucs", type=int)
    ap.add_argument("--activation", default="PReLU")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8", "int8_static"],
                    help="int8/int8_static (UtNet only): the quantized forward; "
                         "int8_static recalibrates on each request")
    ap.add_argument("--devices", type=int, nargs="?", const=0,
                    help="devices to serve on (absent or without a value: every "
                         "visible GPU; with --device cpu, logical CPU devices)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--parallel", default="auto",
                    choices=["auto", "shard", "images", "single"],
                    help="multi-device strategy: shard = row-band split of each "
                         "request over all devices (lowest latency); images = "
                         "request-per-device pool (highest aggregate throughput "
                         "under concurrent load); auto = shard when >1 device")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8601)
    ap.add_argument("--max_pending", type=int, default=8,
                    help="queued-request bound; beyond it requests get 503")
    ap.add_argument("--prewarm", action="append", default=[], metavar="HxW[:dtype]",
                    help="run each coalesced group size once at this request "
                         "shape before accepting traffic (repeatable; e.g. "
                         "--prewarm 480x480:uint16)")
    args = ap.parse_args(argv)

    svc = DenoiseService(args.network, args.model_path, cs=args.cs, ucs=args.ucs,
                         activation=args.activation, batch_size=args.batch_size,
                         compute_dtype=args.compute_dtype, device=args.device,
                         max_pending=args.max_pending, parallel=args.parallel,
                         devices=args.devices)
    for spec in args.prewarm:
        shape, _, dt = spec.partition(":")
        h, _, w = shape.lower().partition("x")
        info = svc.prewarm(int(h), int(w), dtype=dt or "uint16")
        print(f"denoise-serve: prewarmed {spec}: {info}", flush=True)
    httpd = serve(svc, args.host, args.port)
    # report the bound port (--port 0 = ephemeral)
    print(f"denoise-serve: listening on http://{args.host}:{httpd.server_address[1]} "
          f"({svc.ndev} device(s), first {svc.device}, mode={svc.mode}, "
          f"cs={svc.cs}/ucs={svc.ucs})", flush=True)

    # SIGTERM, the orchestrator's stop signal: stop accepting, drain the
    # in-flight requests, exit 0. shutdown() must run off the serving
    # thread, and server_close() joins the in-flight handler threads
    # before the service retires its dispatcher.
    import signal

    def _term(signum, frame):
        print("denoise-serve: SIGTERM — draining in-flight requests", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # not the main thread (embedded use): the caller owns signals
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        svc.close()
    print("denoise-serve: shut down cleanly", flush=True)


if __name__ == "__main__":
    main()
