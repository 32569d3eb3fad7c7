"""The port's multi-device inference (``nind_denoise_tpu_torch/parallel``)
on the CPU, with ``--devices 2``/``3`` as logical CPU devices.

Against the JAX package on its virtual 8-device CPU mesh, fp32, on the
same seeded checkpoint: ``denoise_image_cli --devices 2`` tiled and with
``--whole_image`` (uint16 outputs within 1 LSB, i.e. atol 1.5e-5, and
above 80 dB), ``denoise_cli``'s directory batch (pre-encode uint8 within 1
LSB), and a two-process ``eval/denoise_dir`` (torchrun's variables,
``gloo`` on 127.0.0.1) against JAX's single-process set means.

Within the port, on the CPU: the row-band engine against one engine
(bit for bit in bf16; in fp32 bit for bit except where four tiles meet at
a band seam, within an fp32 ulp), its bytes against JAX's formula; the
batch engine and the pool against one engine per image, bit for bit, with
the pool's order, backpressure, ``close`` and ``reload`` atomicity;
spatial against the whole forward at a height no device count divides
(torch's CPU convolutions round by the spatial extent: within 2e-7); TP
against the single forward, bit for bit; ``process_shard``,
``init_distributed`` on one process, JAX's ``need n devices`` error, and
the device guard of every kernel wrapper.
"""

import contextlib
import os
import queue
import socket
import subprocess
import sys
import threading
import types

import cv2
import numpy as np
import pytest
import torch

from nind_denoise_tpu.engine import tile_engine as jax_engine
from nind_denoise_tpu.eval import denoise_dir as jax_dd
from nind_denoise_tpu.pipeline import denoise_cli as jax_cli
from nind_denoise_tpu.pipeline import denoise_image_cli as jax_image_cli
from nind_denoise_tpu_torch.engine import tile_engine as te
from nind_denoise_tpu_torch.models.utnet import UtNet
from nind_denoise_tpu_torch.ops import _build, deriche, enc1, gauss_blur, qconv, rl_fused
from nind_denoise_tpu_torch.parallel import (batch_engine, engine_pool, mesh,
                                             sharded_engine, spatial, tensor_parallel)
from nind_denoise_tpu_torch.pipeline import denoise_cli as port_cli
from nind_denoise_tpu_torch.pipeline import denoise_image_cli as port_image_cli
from nind_denoise_tpu_torch.tools import fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = dict(cs=104, ucs=88)
CPU2 = ["cpu", "cpu"]
CHILD_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("par") / "generator_1.npz")
    fixtures.write_jax_checkpoint(path, 8, seed=7)
    return path


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(3)
    return UtNet(8)


def _raw(h, w, seed):
    return np.random.default_rng(seed).integers(0, 65536, (h, w, 3), dtype=np.uint16)


def _psnr_db(a, b, peak=65535.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(peak ** 2 / mse)


# -- against the JAX package ---------------------------------------------------

@pytest.fixture(scope="module")
def image_runs(tmp_path_factory, ckpt):
    """{mode: (jax uint16, port uint16)} of denoise_image --devices 2. JAX's
    whole-image forward takes sizes the architecture takes: 200 x 264 with
    --pad 8 is 216 x 280."""
    d = tmp_path_factory.mktemp("image")
    src = str(d / "in.png")
    cv2.imwrite(src, _raw(200, 264, 1))
    common = ["-i", src, "--network", "UtNet", "--model_path", ckpt, "--cs", "104",
              "--ucs", "88", "-b", "4", "--compute_dtype", "float32",
              "--precision", "float32", "--exif_method", "noexif", "--devices", "2"]
    out = {}
    for mode, extra in (("tiled", []), ("whole", ["--whole_image", "--pad", "8"])):
        jax_image_cli.main(common + extra + ["-o", str(d / f"jax_{mode}.tif")])
        port_image_cli.main(common + extra + ["-o", str(d / f"port_{mode}.tif"),
                                              "--device", "cpu"])
        out[mode] = tuple(cv2.imread(str(d / f"{side}_{mode}.tif"), cv2.IMREAD_UNCHANGED)
                          for side in ("jax", "port"))
    return out


@pytest.mark.parametrize("mode", ["tiled", "whole"])
def test_image_cli_devices_2_matches_jax(image_runs, mode):
    ref, got = image_runs[mode]
    assert got.dtype == ref.dtype == np.uint16 and got.shape == ref.shape == (200, 264, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert _psnr_db(got, ref) > 80
    assert 0 < ref.mean() < 65535 and len(np.unique(ref)) > 100


def _capture_u8(monkeypatch, module):
    seen = []
    encode = module._encode_u8
    monkeypatch.setattr(module, "_encode_u8", lambda u8, path, q: (
        seen.append((os.path.basename(str(path)), np.array(u8))), encode(u8, path, q)))
    return seen


def _write_dir(d, shapes, seed):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i, hw in enumerate(shapes):
        cv2.imwrite(str(d / f"f{i}.tif"), rng.integers(0, 65536, (*hw, 3)).astype(np.uint16))
    return d


# two same-shape images (the image batcher), two more shapes (the pool)
DIR_SHAPES = [(150, 170), (150, 170), (120, 200), (110, 140)]


def test_cli_directory_devices_2_matches_jax(tmp_path, monkeypatch, ckpt):
    src = _write_dir(tmp_path / "in", DIR_SHAPES, 4)
    common = [str(src), "--tiff-input", "--model_path", ckpt, "--cs", "104", "--ucs", "88",
              "--batch_size", "4", "--compute_dtype", "float32", "--devices", "2",
              "--iterations", "3"]
    seen = {"jax": _capture_u8(monkeypatch, jax_cli), "port": _capture_u8(monkeypatch, port_cli)}
    for side, mod, extra in (("jax", jax_cli, []), ("port", port_cli, ["--device", "cpu"])):
        (tmp_path / side).mkdir()
        mod.main(common + ["-o", str(tmp_path / side)] + extra)
    ref, got = dict(seen["jax"]), dict(seen["port"])
    assert sorted(got) == sorted(ref) == [f"f{i}.jpg" for i in range(4)]
    for name in ref:
        assert got[name].shape == ref[name].shape and got[name].dtype == np.uint8
        assert np.abs(got[name].astype(int) - ref[name].astype(int)).max() <= 1, name


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


EVAL_CHILD = """
import functools, json, sys
from nind_denoise_tpu_torch.engine import tile_engine
from nind_denoise_tpu_torch.eval import denoise_dir as dd
dd.AdaptiveEngine = functools.partial(tile_engine.AdaptiveEngine, compute_dtype="float32")
print("OVERALL " + json.dumps(dd.main(sys.argv[1:])))
"""


def test_denoise_dir_two_processes_matches_jax(tmp_path, monkeypatch, ckpt):
    """Two processes (torchrun's variables, gloo): each takes every other
    image of a set; the gathered set means and the first process's
    ``testres.json`` match JAX's single-process run (float32), and only
    the first process writes it."""
    scenes = tmp_path / "scenes"
    rng = np.random.default_rng(9)
    for aset, n_noisy in (("S1", 3), ("S2", 1)):
        (scenes / aset).mkdir(parents=True)
        clean = cv2.resize(rng.random((22, 24, 3)).astype(np.float32), (192, 176))
        cv2.imwrite(str(scenes / aset / f"NIND_{aset}_ISO100.png"),
                    (np.clip(clean, 0, 1) * 65535).astype(np.uint16))
        for k in range(n_noisy):
            noisy = np.clip(clean + rng.normal(0, 0.05, clean.shape), 0, 1)
            cv2.imwrite(str(scenes / aset / f"NIND_{aset}_ISO{800 * (k + 1)}.png"),
                        (noisy * 65535).astype(np.uint16))
    common = ["--noisy_dir", str(scenes), "--network", "UtNet", "--cs", "104",
              "--ucs", "88", "--batch_size", "4"]
    jax_ck = tmp_path / "jax" / "model" / "generator_5.npz"
    port_ck = tmp_path / "port" / "model" / "generator_5.npz"
    for p in (jax_ck, port_ck):
        p.parent.mkdir(parents=True)
        p.write_bytes(open(ckpt, "rb").read())
    for name in ("resolve_apply_fn", "make_engine"):  # JAX's denoise_dir in float32
        fn = getattr(jax_engine, name)
        monkeypatch.setattr(jax_engine, name, lambda *a, _fn=fn, **kw: _fn(
            *a, **{**kw, "compute_dtype": "float32"}))
    ref = jax_dd.main(["--model_path", str(jax_ck), *common, "--devices", "1",
                       "--result_dir", str(tmp_path / "jax" / "results")])
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               OMP_NUM_THREADS="2")
    argv = ["--model_path", str(port_ck), *common, "--device", "cpu",
            "--result_dir", str(tmp_path / "port" / "results")]
    procs = [subprocess.Popen([sys.executable, "-c", EVAL_CHILD, *argv], cwd=ROOT,
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r}:\n{out[-3000:]}"
    import json

    overall = [json.loads(next(l for l in out.splitlines() if l.startswith("OVERALL "))[8:])
               for out in outs]
    assert overall[0] == overall[1]
    assert "process 0 takes every 2th image" in outs[0]
    for k in ("mse", "ssim", "msssim"):
        assert abs(overall[0][k] - ref[k]) <= 1e-6, (k, overall[0][k], ref[k])
    rec = json.loads((port_ck.parent / "testres.json").read_text())
    ref_rec = json.loads((jax_ck.parent / "testres.json").read_text())
    assert rec.keys() == ref_rec.keys()
    written = sorted(os.listdir(tmp_path / "port" / "results" / "model"))
    assert written == sorted(os.listdir(tmp_path / "jax" / "results" / "model"))


# -- the row-band engine ----------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sharded_matches_single_engine(model, n, dtype):
    """An uneven grid (3 tile rows of 4 tiles) over 2 and 3 devices: the
    single engine at the same tiles per dispatch."""
    raw = _raw(200, 260, 2)
    sharded = te.make_sharded_denoiser("UtNet", model, ["cpu"] * n, batch_size=4,
                                       compute_dtype=dtype, **TILE)
    single = te.make_engine("UtNet", model, batch_size=max(1, 4 // n), compute_dtype=dtype,
                            device="cpu", **TILE)
    got = sharded.denoise_raw(raw, 65535.0)
    ref = single.denoise_raw(raw, 65535.0)
    plan = single.plan_for(200, 260)
    assert got.shape == ref.shape == (200, 260, 3) and got.dtype == np.float32
    diff = got != ref
    if dtype == "bfloat16":
        assert not diff.any()
    else:
        # only where four tiles meet at a seam between two bands
        seams = [r0 * plan.stride for r0, _ in sharded_engine.row_bands(3, n)[1:]]
        corner = np.zeros(got.shape[:2], bool)
        for y in seams:
            for x in range(plan.stride, 260, plan.stride):
                corner[y:y + plan.ol, x:x + plan.ol] = True
        assert not diff.any(axis=2)[~corner].any()
        ulp = np.spacing(np.abs(ref))
        assert (np.abs(got - ref) <= ulp).all()
    assert np.array_equal(sharded.denoise_raw(raw, 65535.0, "uint16"),
                          single.denoise_raw(raw, 65535.0, "uint16"))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sharded_bytes_follow_jax_formula(model, n):
    """uploads = padded rows + (n-1) overlaps of cs - stride rows, at the raw
    width in the storage dtype; downloads = the fp32 canvas + (n-1)
    overlaps of ol rows. Four devices over three tile rows: one idles."""
    raw = _raw(200, 260, 3)
    sharded = te.make_sharded_denoiser("UtNet", model, ["cpu"] * n, batch_size=4,
                                       compute_dtype="bfloat16", **TILE)
    sharded.denoise_raw(raw, 65535.0)
    plan = te.TilePlan(200, 260, 104, 88)
    used = min(n, plan.ipervl + 1)
    padded_h = plan.ipervl * plan.stride + 104
    assert sharded.last_bytes_uploaded == \
        (padded_h + (used - 1) * (104 - plan.stride)) * 260 * 3 * 2
    assert sharded.last_bytes_downloaded == \
        (plan.grid_h + (used - 1) * plan.ol) * plan.grid_w * 3 * 4


def test_sharded_int8_static_matches_single(model):
    raw = _raw(200, 260, 5)
    calib = qconv.calib_from_image(raw, scale=65535.0)
    sharded = te.make_sharded_denoiser("UtNet", model, CPU2, batch_size=4,
                                       compute_dtype="int8_static", calib=calib, **TILE)
    single = te.make_engine("UtNet", model, batch_size=2, compute_dtype="int8_static",
                            calib=calib, device="cpu", **TILE)
    assert np.array_equal(sharded.denoise_raw(raw, 65535.0, "uint16"),
                          single.denoise_raw(raw, 65535.0, "uint16"))


# -- the batch engine and the pool ------------------------------------------------

def test_batch_engine_matches_one_engine_per_image(model):
    raws = [_raw(150, 170, s) for s in (6, 7)]
    engines = [te.TileEngine(fn, **TILE, batch_size=2, compute_dtype="float32",
                             size_check=te.size_check("UtNet"), device="cpu")
               for fn in te.replicate_apply_fn("UtNet", model, "float32", CPU2)]
    batcher = batch_engine.DeviceBatchDenoiser(engines)
    single = te.make_engine("UtNet", model, batch_size=2, compute_dtype="float32",
                            device="cpu", **TILE)
    got = batcher.denoise_batch(raws, 65535.0)
    refs = [single.denoise_raw(r, 65535.0) for r in raws]
    for g, r in zip(got, refs):
        assert np.array_equal(g, r)
    deblurred = batcher.denoise_batch(raws, 65535.0, post=lambda i, out: (
        batch_engine.rl_deblur_sharded([out], 1.0, 3)[0].numpy()))
    for g, r in zip(deblurred, refs):
        assert np.array_equal(g, batch_engine.rl_deblur.rl_deblur(
            torch.from_numpy(r), 1.0, 3).numpy())
    assert len(batcher.denoise_many(raws * 2, 65535.0)) == 4
    with pytest.raises(ValueError, match="exceeds"):
        batcher.denoise_batch(raws * 2, 65535.0)


@pytest.fixture
def pool(model):
    p = engine_pool.EnginePool("UtNet", model, CPU2, compute_dtype="float32", **TILE)
    yield p
    p.close()


def test_pool_matches_single_engine_and_keeps_order(pool, model):
    single = te.AdaptiveEngine("UtNet", model, compute_dtype="float32", device="cpu", **TILE)
    raws = [_raw(*hw, s) for s, hw in enumerate([(150, 170), (104, 120), (60, 70)])]
    got = pool.map(raws, lambda w, r: (w.denoise_raw(r, 65535.0), w.device))
    for (out, dev), r in zip(got, raws):
        assert dev.type == "cpu" and np.array_equal(out, single.denoise_raw(r, 65535.0))
    assert pool.map(range(10), lambda w, i: i * i) == [i * i for i in range(10)]
    assert pool.names == ["cpu#0", "cpu#1"]
    with pytest.raises(ZeroDivisionError):
        pool.submit(lambda w: 1 / 0)
    assert pool.submit(lambda w: 41) == 41


def test_pool_typed_submissions_coalesce_per_worker(model):
    """Eight same-key requests queued behind two parked workers: each worker
    takes its fair share (4), and every result equals the serial engine."""
    p = engine_pool.EnginePool("UtNet", model, CPU2, compute_dtype="float32", **TILE)
    try:
        imgs = [_raw(96, 100, 40 + i) for i in range(8)]
        refs = [p._replicas[0].denoise_raw(im, 65535.0) for im in imgs]
        gate, release, parked = threading.Barrier(3), threading.Event(), []

        def blocker(w):
            parked.append(w)
            gate.wait(10)
            return release.wait(30)

        bts = [threading.Thread(target=lambda: p.submit(blocker)) for _ in range(2)]
        for t in bts:
            t.start()
        gate.wait(10)
        results = [None] * 8

        def den(i):
            results[i] = p.submit_denoise(imgs[i], 65535.0, lambda e, out, meta: (
                out.numpy().copy(), meta["group"], meta["device"]))

        threads = [threading.Thread(target=den, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for _ in range(400):
            if p._q.qsize() >= 8:
                break
            threading.Event().wait(0.02)
        release.set()
        for t in threads + bts:
            t.join(60)
        assert p.coalesced >= 2
        assert max(g for _, g, _ in results) <= 4
        for (arr, _, _), ref in zip(results, refs):
            assert np.array_equal(arr, ref)
    finally:
        p.close()


def test_pool_backpressure_and_close(model):
    p = engine_pool.EnginePool("UtNet", model, ["cpu"], compute_dtype="float32",
                               max_pending=1, **TILE)
    started, release = threading.Event(), threading.Event()

    def hold(w):
        started.set()
        return release.wait(30)

    t1 = threading.Thread(target=lambda: p.submit(hold))
    t1.start()
    assert started.wait(30)
    t2 = threading.Thread(target=lambda: p.submit(lambda w: 1))
    t2.start()
    for _ in range(200):
        if p._q.full():
            break
        threading.Event().wait(0.02)
    assert p._q.full()
    with pytest.raises(queue.Full):
        p.submit(lambda w: 2, block=False)
    release.set()
    t1.join(30)
    t2.join(30)
    # close() releases a waiter whose job no worker will run
    p.close()
    done = {"event": threading.Event()}
    p._q.put_nowait((lambda w: 0, done))
    p.close()
    assert done["event"].is_set() and isinstance(done.get("error"), RuntimeError)
    with pytest.raises(RuntimeError, match="closed"):
        p.submit(lambda w: 0)


def test_pool_reload_is_atomic(model, monkeypatch):
    """A rebuild that fails on one device leaves every replica on the old
    weights; an unbroken reload then swaps every replica."""
    torch.manual_seed(11)
    model_b = UtNet(8)
    p = engine_pool.EnginePool("UtNet", model, CPU2, compute_dtype="float32", **TILE)
    try:
        img = _raw(104, 104, 21)
        old = [r.denoise_raw(img, 65535.0) for r in p._replicas]
        real, calls = engine_pool.AdaptiveEngine, []

        class Flaky(real):
            def __init__(self, *a, **kw):
                calls.append(1)
                if len(calls) == 2:
                    raise RuntimeError("simulated device OOM")
                super().__init__(*a, **kw)

        monkeypatch.setattr(engine_pool, "AdaptiveEngine", Flaky)
        with pytest.raises(RuntimeError, match="previous checkpoint"):
            p.reload(model_b)
        monkeypatch.setattr(engine_pool, "AdaptiveEngine", real)
        for r, ref in zip(p._replicas, old):
            assert np.array_equal(r.denoise_raw(img, 65535.0), ref)
        p.reload(model_b)
        new = te.AdaptiveEngine("UtNet", model_b, compute_dtype="float32", device="cpu",
                                **TILE).denoise_raw(img, 65535.0)
        assert not np.array_equal(new, old[0])
        for r in p._replicas:
            assert np.array_equal(r.denoise_raw(img, 65535.0), new)
    finally:
        p.close()


# -- spatial and tensor parallel --------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_spatial_matches_whole_forward(model, n):
    """A 1001-row image (padded to 1016, which 3 does not divide): bands
    on multiples of 16, kept rows within fp32 rounding of the whole forward,
    each band shorter than the image."""
    img = np.random.default_rng(12).random((3, 1001, 70), dtype=np.float32)
    ref = te.make_engine("UtNet", model, compute_dtype="float32", device="cpu",
                         **TILE).denoise_whole(img)
    fwd = spatial.SpatialShardedForward(
        te.replicate_apply_fn("UtNet", model, "float32", ["cpu"] * n), ["cpu"] * n,
        te.size_check("UtNet"), torch.float32)
    got = fwd(img.transpose(1, 2, 0)).transpose(2, 0, 1)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2e-7
    bands = fwd.last_bands
    assert len(bands) == n and bands[0][2] == 0 and bands[-1][3] == 1016
    assert all(e - s < 1016 for s, e, _, _ in bands)
    assert all(o0 % 16 == 0 and s % 16 == 0 for s, _, o0, _ in bands)
    assert spatial.device_count(1001, 3) == 1 and spatial.device_count(1016, 3) == 2


@pytest.mark.parametrize("n", [2, 4])
def test_tensor_parallel_matches_single_forward(model, n):
    m = model.eval()
    x = torch.from_numpy(np.random.default_rng(13).random((2, 3, 104, 136),
                                                          dtype=np.float32))
    with torch.no_grad():
        ref = m(x)
    tp = tensor_parallel.shard_params_tp(m, ["cpu"] * n)
    split = [name for name, q in tp.named_modules() if isinstance(q, tensor_parallel.TPConv)]
    assert "convs1.0" not in split and "tconvs4.4" not in split and len(split) == 20
    assert torch.equal(tensor_parallel.tp_forward(tp)(x), ref)


# -- devices, processes, the device guard -------------------------------------------

def test_make_devices_and_too_few_gpus(monkeypatch, tmp_path, ckpt):
    assert mesh.make_devices(None, "cpu") == [torch.device("cpu")]
    assert mesh.make_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert mesh.make_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.make_devices(None) == [torch.device("cuda", 0)]
    assert mesh.make_devices(0) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        mesh.make_devices(2)
    src = str(tmp_path / "in.png")
    cv2.imwrite(src, _raw(60, 70, 1))
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        port_image_cli.main(["-i", src, "-o", str(tmp_path / "o.tif"), "--network", "UtNet",
                             "--model_path", ckpt, "--devices", "2"])


def test_process_shard_and_init_distributed_on_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed() is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.init_distributed() is False
    assert mesh.process_count() == 1 and mesh.process_index() == 0
    assert mesh.process_shard(range(5)) == [0, 1, 2, 3, 4]
    assert mesh.process_allgather(np.array([1.0, 2.0])).tolist() == [[1.0, 2.0]]
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(ValueError, match="coordinator"):
        mesh.init_distributed(num_processes=2, process_id=0)
    monkeypatch.setattr(mesh, "process_count", lambda: 3)
    monkeypatch.setattr(mesh, "process_index", lambda: 1)
    assert mesh.process_shard(range(8)) == [1, 4, 7]
    assert mesh.pad_to_multiple(np.ones((5, 2)), 4)[0].shape == (8, 2)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on cuda:1: transfers to a CUDA device
    stay on the CPU."""

    @property
    def device(self):
        return torch.device("cuda", 1)

    def to(self, *args, **kw):
        args = [a for a in args if not (isinstance(a, (torch.device, str))
                                        and torch.device(a).type == "cuda")]
        kw.pop("device", None)
        return super().to(*args, **kw)


def _fake(t):
    return torch.Tensor._make_subclass(_FakeCuda, t.contiguous())


def test_every_kernel_wrapper_launches_under_its_tensors_device(monkeypatch):
    """Each wrapper's ctypes call runs with its tensor's device current: a
    fake library records the current device at each launch, for tensors on
    a second (mocked) device."""
    current, seen = [torch.device("cuda", 0)], []

    @contextlib.contextmanager
    def device(d):
        prev = current[0]
        current[0] = torch.device(d)
        try:
            yield
        finally:
            current[0] = prev

    class Lib:
        def __getattr__(self, name):
            return lambda *a: seen.append((name, current[0])) or 0

    empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: _fake(empty(*a, **kw)))
    monkeypatch.setattr(_build, "library", lambda name, sig: Lib())
    pack = enc1._pack_index
    monkeypatch.setattr(enc1, "_pack_index", lambda f, d: pack(f, torch.device("cpu")))
    taps = gauss_blur._device_taps
    monkeypatch.setattr(gauss_blur, "_device_taps",
                        lambda s, d: _fake(taps(s, torch.device("cpu"))))
    f32 = lambda *s: _fake(torch.rand(*s))
    bf = lambda *s: _fake(torch.rand(*s).to(torch.bfloat16))
    t3 = _fake(torch.tensor([0.25, 0.5, 0.25]))
    calls = {
        "enc1": lambda: enc1.enc1(bf(1, 3, 12, 12), bf(64, 3, 3, 3), bf(64), bf(1),
                                  bf(64, 64, 3, 3), bf(64), bf(1)),
        "enc1_f32": lambda: enc1.enc1(f32(1, 3, 12, 12), f32(64, 3, 3, 3), f32(64), f32(1),
                                      f32(64, 64, 3, 3), f32(64), f32(1)),
        "rl_iter": lambda: rl_fused.rl_iter(f32(3, 8, 8), f32(3, 8, 8), t3, out=f32(3, 8, 8)),
        "gauss_blur": lambda: gauss_blur.gauss_blur(f32(8, 8, 3), 1.0),
        "blur_planes": lambda: gauss_blur.blur_planes(f32(3, 8, 8), t3, out=f32(3, 8, 8)),
        "qconv": lambda: qconv.conv_int8(
            _fake(torch.zeros(1, 8, 8, 16, dtype=torch.int8)),
            _fake(torch.zeros(16, 3, 3, 16, dtype=torch.int8)), (0, 0, 0, 0),
            sx=f32(1), sw=f32(16)),
        "deriche": lambda: deriche.deriche_axis(f32(3, 8, 8), 1.0, 1, out=f32(3, 8, 8)),
    }
    mods = {"enc1": enc1, "enc1_f32": enc1, "rl_iter": rl_fused, "gauss_blur": gauss_blur,
            "blur_planes": gauss_blur, "qconv": qconv, "deriche": deriche}
    for name, call in calls.items():
        seen.clear()
        before = mods[name].launches
        call()
        assert seen and all(dev == torch.device("cuda", 1) for _, dev in seen), (name, seen)
        assert mods[name].launches == before + len(seen), name
        assert current[0] == torch.device("cuda", 0)


def test_deriche_sets_its_attribute_at_every_launch():
    src = open(os.path.join(ROOT, "nind_denoise_tpu_torch", "csrc", "deriche.cu")).read()
    assert "static bool attr" not in src
    launch = src[src.index("cudaError_t launch(const Params& q"):]
    launch = launch[:launch.index("\n}\n")]
    assert "cudaFuncSetAttribute" in launch and "if (!attr)" not in launch
