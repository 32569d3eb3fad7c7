"""The port's serving daemon (pipeline/serve.py) on the CPU, in single
mode: the real server on a loopback port driven with urllib, held against
the port's own engine and, for one RL request, against the JAX service;
coalescing, backpressure, reload, prewarm, shutdown and the dispatcher's
work queue."""

import http.client
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import cv2
import numpy as np
import pytest
import torch

import jax

from nind_denoise_tpu.models import params_io as jax_params_io
from nind_denoise_tpu.models.utnet import UtNet as JaxUtNet
from nind_denoise_tpu.pipeline import serve as jax_serve
from nind_denoise_tpu_torch.pipeline import serve as serve_mod
from nind_denoise_tpu_torch.utils import workqueue

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(cs=104, ucs=88, compute_dtype="float32", device="cpu")


def _ckpt(path, seed):
    jax_params_io.save(JaxUtNet.init(jax.random.PRNGKey(seed), funit=8), str(path))
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("srv")
    return _ckpt(d / "generator_1.npz", 0), _ckpt(d / "generator_2.npz", 42)


@pytest.fixture(scope="module")
def server(ckpts):
    svc = serve_mod.DenoiseService("UtNet", ckpts[0], **KW)
    httpd = serve_mod.serve(svc, "127.0.0.1", 0)  # ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield svc, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    svc.close()


def _png(img):
    ok, buf = cv2.imencode(".png", img[..., ::-1])
    assert ok
    return buf.tobytes()


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 65536, (h, w, 3), dtype=np.uint16)


def _post(base, img, query="output=png&rl=0"):
    req = urllib.request.Request(f"{base}/denoise?{query}", data=_png(img),
                                 method="POST")
    return urllib.request.urlopen(req, timeout=120).read()


def _decode(body):
    return cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_UNCHANGED)[..., ::-1]


def _want(svc, img):
    """The engine's own result for an rl=0 request."""
    return svc._adaptive.denoise_raw(img, 65535.0, out_dtype="uint8")


def _parked(svc):
    """Park the dispatcher inside a generic job; returns (release, thread)."""
    gate, release = threading.Event(), threading.Event()

    def blocker():
        gate.set()
        return release.wait(60)

    t = threading.Thread(target=lambda: svc.submit(blocker))
    t.start()
    assert gate.wait(30)
    return release, t


def _wait_queued(svc, n):
    deadline = time.monotonic() + 60
    while svc._q.qsize() < n and time.monotonic() < deadline:
        time.sleep(0.02)
    assert svc._q.qsize() >= n


def _burst(svc, base, imgs, query):
    """Queue every request behind the parked dispatcher, then release it,
    so that they run as one coalesced group."""
    release, bt = _parked(svc)
    bodies = [None] * len(imgs)

    def hit(i):
        bodies[i] = _post(base, imgs[i], query)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(imgs))]
    for t in threads:
        t.start()
    _wait_queued(svc, len(imgs))
    release.set()
    for t in threads + [bt]:
        t.join(120)
        assert not t.is_alive()
    return bodies


def test_healthz_and_stats(server):
    svc, base = server
    h = json.loads(urllib.request.urlopen(base + "/healthz").read())
    assert h == {"status": "ok", "devices": 1, "mode": "single", "cs": 104, "ucs": 88}
    s = json.loads(urllib.request.urlopen(base + "/stats").read())
    assert {"requests", "errors", "megapixels", "latency_ms", "stage_s",
            "group_sizes", "coalesced_requests", "rejected_busy"} <= set(s)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope")
    assert e.value.code == 404


def test_fresh_service_latency_block(ckpts):
    svc = serve_mod.DenoiseService("UtNet", ckpts[0], **KW)
    try:
        assert svc.snapshot_stats()["latency_ms"] == {
            "window": 0, "mean": None, "p50": None, "p95": None, "p99": None,
            "max": None}
    finally:
        svc.close()


def test_roundtrip_matches_engine_and_fills_stats(server):
    svc, base = server
    img = _img(120, 150, 0)
    before = svc.snapshot_stats()
    got = _decode(_post(base, img))
    np.testing.assert_array_equal(got, _want(svc, img))
    after = svc.snapshot_stats()
    for k in ("decode", "denoise", "post", "encode"):
        assert after["stage_s"][k] > before["stage_s"][k], k
    lat = after["latency_ms"]
    assert lat["window"] == before["latency_ms"]["window"] + 1
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]


def test_rl_response_matches_jax_service_within_one_lsb(server, ckpts):
    svc, _ = server
    data = _png(_img(104, 120, 1))
    jsvc = jax_serve.DenoiseService("UtNet", ckpts[0], cs=104, ucs=88,
                                    compute_dtype="float32", devices=1)
    try:
        ref = _decode(jsvc.denoise_bytes(data, output="png", iterations=3))
    finally:
        jsvc.close()
    got = _decode(svc.denoise_bytes(data, output="png", iterations=3))
    assert got.shape == ref.shape == (104, 120, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_concurrent_requests_coalesce_and_equal_serial(server):
    svc, base = server
    imgs = [_img(120, 150, 40 + i) for i in range(3)]
    before = svc.snapshot_stats()
    bodies = _burst(svc, base, imgs, "output=png&rl=0")
    after = svc.snapshot_stats()
    assert after["coalesced_requests"] == before["coalesced_requests"] + 3
    assert after["group_sizes"].get("3", 0) == before["group_sizes"].get("3", 0) + 1
    for img, body in zip(imgs, bodies):
        np.testing.assert_array_equal(_decode(body), _want(svc, img))


def test_coalesced_rl_group_matches_serial_requests(server):
    svc, base = server
    imgs = [_img(104, 112, 47 + i) for i in range(3)]
    query = "output=png&iterations=3"
    serial = [_post(base, im, query) for im in imgs]
    assert _burst(svc, base, imgs, query) == serial  # byte-identical PNGs


def test_small_and_tiny_images(server):
    svc, base = server
    for hw in ((64, 72), (33, 47)):  # an adapted tiling; below the minimum
        img = _img(*hw, 5)
        np.testing.assert_array_equal(_decode(_post(base, img)), _want(svc, img))
    assert "tiny" in svc._adaptive._engines


@pytest.mark.parametrize("query,body,match", [
    ("output=png", b"not an image", "decode"),
    ("output=exe", None, "output format"),
    ("output=png&psf=gmic_fast", None, "not ported"),
    ("output=png&psf=box", None, "unknown psf"),
])
def test_bad_requests_are_400_before_the_denoise(server, query, body, match):
    svc, base = server
    mp = svc.snapshot_stats()["megapixels"]
    data = body if body is not None else _png(_img(64, 64, 3))
    req = urllib.request.Request(f"{base}/denoise?{query}", data=data, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400 and match in json.loads(e.value.read())["error"]
    assert svc.snapshot_stats()["megapixels"] == mp


@pytest.mark.parametrize("length,code", [("abc", 400), ("-5", 400), ("0", 411),
                                         (str(600 << 20), 413)])
def test_content_length_errors(server, length, code):
    _, base = server
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", "/denoise")
        conn.putheader("Content-Length", length)
        conn.endheaders()
        r = conn.getresponse()
        assert r.status == code
        assert "error" in json.loads(r.read())
    finally:
        conn.close()


def test_queue_full_is_service_busy_and_503(server):
    svc, base = server
    release, bt = _parked(svc)
    try:
        for _ in range(svc._q.maxsize):  # fill every slot
            svc._q.put_nowait((lambda: None, {"event": threading.Event()}))
        with pytest.raises(serve_mod.ServiceBusy):
            svc.submit(lambda: None)
        rejected = svc.snapshot_stats()["rejected_busy"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, _img(64, 64, 4))
        assert e.value.code == 503
        assert svc.snapshot_stats()["rejected_busy"] == rejected + 1
    finally:
        release.set()
        bt.join(30)
    deadline = time.monotonic() + 30
    while not svc._q.empty() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert svc._q.empty()


def test_failed_dispatch_still_records_latency(server, monkeypatch):
    svc, _ = server
    before = svc.snapshot_stats()["latency_ms"]["window"]

    def boom(*a, **kw):
        raise RuntimeError("engine blew up")

    monkeypatch.setattr(svc, "submit_denoise", boom)
    with pytest.raises(RuntimeError, match="blew up"):
        svc.denoise_bytes(_png(_img(64, 64, 6)), output="png")
    assert svc.snapshot_stats()["latency_ms"]["window"] == before + 1


def test_dispatcher_survives_base_exception(server):
    svc, _ = server

    def fatal():
        raise SystemExit(3)

    with pytest.raises(RuntimeError, match="fatal dispatcher error"):
        svc.submit(fatal)
    assert svc.submit(lambda: 41 + 1) == 42


def test_prewarm(server):
    svc, base = server
    info = svc.prewarm(104, 120, dtype="uint16", rl=False)
    assert info["mode"] == "single"
    assert info["sizes"] == list(range(1, svc.MAX_COALESCE + 1))
    img = _img(104, 120, 21)
    np.testing.assert_array_equal(_decode(_post(base, img)), _want(svc, img))


def test_reload_rolls_weights_without_dropping(ckpts):
    svc = serve_mod.DenoiseService("UtNet", ckpts[0], **KW)
    httpd = serve_mod.serve(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        img = _img(104, 120, 9)
        old = _want(svc, img)
        # a request queued before the reload runs on the old weights
        release, bt = _parked(svc)
        early = {}
        t = threading.Thread(target=lambda: early.update(b=_post(base, img)))
        t.start()
        _wait_queued(svc, 1)
        tr = threading.Thread(target=lambda: urllib.request.urlopen(
            urllib.request.Request(base + "/reload?" + urllib.parse.urlencode(
                {"model_path": ckpts[1]}), data=b"", method="POST")).read())
        tr.start()
        _wait_queued(svc, 2)
        release.set()
        for th in (t, tr, bt):
            th.join(60)
            assert not th.is_alive()
        np.testing.assert_array_equal(_decode(early["b"]), old)
        assert svc.snapshot_stats()["reloads"] == 1
        after = _decode(_post(base, img))
        assert not np.array_equal(after, old)
        np.testing.assert_array_equal(after, _want(svc, img))
        for q in ("", "?model_path=/nonexistent/ckpt.npz"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    base + "/reload" + q, data=b"", method="POST"))
            assert e.value.code == 400
        np.testing.assert_array_equal(_decode(_post(base, img)), after)
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()


def test_close_never_blocks_and_later_submits_raise(ckpts):
    svc = serve_mod.DenoiseService("UtNet", ckpts[0], **KW)
    release, bt = _parked(svc)
    for _ in range(svc._q.maxsize):
        svc._q.put_nowait((lambda: None, {"event": threading.Event()}))
    t0 = time.monotonic()
    svc.close()  # the queue is full: must not block on the sentinel
    assert time.monotonic() - t0 < 1.0
    release.set()
    bt.join(10)
    svc._worker.join(10)
    assert not svc._worker.is_alive()
    with pytest.raises(serve_mod.ServiceBusy, match="shutting down"):
        svc.submit(lambda: None)


def test_unported_modes_and_missing_cuda(ckpts, monkeypatch):
    for mode in ("shard", "images"):
        with pytest.raises(NotImplementedError, match="item 9"):
            serve_mod.DenoiseService("UtNet", ckpts[0], parallel=mode, **KW)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.DenoiseService("UtNet", ckpts[0], cs=104, ucs=88)


def test_workqueue_keeps_fifo_around_generic_jobs():
    q, seen = queue.Queue(), []
    jobs = [("den", "a", 1, None), ("den", "a", 2, None), ("gen", None),
            ("den", "a", 3, None), ("den", "b", 4, None), ("den", "b", 5, None),
            ("den", "b", 6, None), None, ("den", "a", 7, None)]
    for j in jobs:
        q.put(j)
    workqueue.consume(q, threading.Event(), lambda j: seen.append(j[0]),
                      lambda g: seen.append([j[2] for j in g]), lambda: 2)
    # the drain stops at the generic job, at the key change, at the limit,
    # and the sentinel ends the consumer before job 7
    assert seen == [[1, 2], "gen", [3], [4, 5], [6]]
    assert q.get_nowait() == ("den", "a", 7, None)


def test_main_serves_and_drains_on_sigterm(ckpts):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.Popen(
        [sys.executable, "-m", "nind_denoise_tpu_torch.pipeline.serve",
         "--model_path", ckpts[0], "--cs", "104", "--ucs", "88",
         "--compute_dtype", "float32", "--device", "cpu", "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line, deadline = "", time.time() + 120
        while "listening on" not in line:
            assert time.time() < deadline and p.poll() is None, "server never came up"
            line = p.stdout.readline()
        port = int(re.search(r"http://[^:]+:(\d+)", line).group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["mode"] == "single"
        p.send_signal(signal.SIGTERM)
        out = p.communicate(timeout=60)[0]
        assert p.returncode == 0, out
        assert "draining" in out and "shut down cleanly" in out, out
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
