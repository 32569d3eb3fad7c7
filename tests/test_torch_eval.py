"""The port's evaluation harness (``nind_denoise_tpu_torch/eval``) against
the JAX package's on the same seeded scenes and checkpoint, on the CPU.

``denoise_dir`` runs in float32 on both sides (JAX's ``resolve_apply_fn``
and ``make_engine`` and the port's ``AdaptiveEngine`` and ``make_engine``
patched to ``compute_dtype="float32"``; JAX on one device): every output
uint16 within 1 LSB of JAX's with at least 99.9 % equal, and ``overall``,
``trainres.json`` and ``testres.json`` within ``JSON_TOL``. The default bf16
runs once against JAX's bf16, held to the bound measured here
(``BF16_LSB``). File scores are held as in ``tests/test_torch_losses.py``
(MS-SSIM 2e-5 absolute, MSE and PSNR 1e-6 relative), but SSIM to 3e-6, not
2e-7: on these smooth scenes (a variance is a small difference of large
window sums) JAX's float32 SSIM (XLA on the CPU) lies 1.3-1.7e-6 from the
same SSIM in float64 and the port's 1.2e-7 at most (measured here). So
``test_file_scores_match_jax`` also holds the port's SSIM and MS-SSIM within
2e-7 of float64, and ``JSON_TOL`` is 3e-6.
"""

import contextlib
import functools
import json
import os

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nind_denoise_tpu.engine import tile_engine as jax_engine
from nind_denoise_tpu.eval import denoise_dir as jax_dd
from nind_denoise_tpu.eval import grapher as jax_grapher
from nind_denoise_tpu.eval import score as jax_score
from nind_denoise_tpu_torch.core import imgio
from nind_denoise_tpu_torch.engine import tile_engine as port_engine
from nind_denoise_tpu_torch.eval import denoise_dir as port_dd
from nind_denoise_tpu_torch.eval import grapher as port_grapher
from nind_denoise_tpu_torch.eval import score as port_score
from nind_denoise_tpu_torch.ops import losses as port_losses
from nind_denoise_tpu_torch.ops.conv import avgpool2x_ceil
from nind_denoise_tpu_torch.tools import fixtures

TOL = {"mse": (0, 1e-6), "ssim": (3e-6, 0), "msssim": (2e-5, 0)}  # (atol, rtol)
JSON_TOL = 3e-6
# the default bf16 run, port against JAX's bf16: at most one bf16 ulp of an
# output in [0.5, 1) (256 uint16 LSB; measured 128), at least 90 % of the
# values equal (measured 93.8 %), scores within 1e-5 (measured 4.4e-6)
BF16_LSB, BF16_EQUAL, BF16_SCORE = 256, 0.9, 1e-5
COMMON = ["--network", "UtNet", "--cs", "104", "--ucs", "88", "--batch_size", "4"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch's default threads under the fast tier's parallel workers
    oversubscribe the host: two a worker, as test_torch_train_gan_cli.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _smooth(rng, h, w):
    img = cv2.resize(rng.random((h // 8, w // 8, 3)).astype(np.float32), (w, h),
                     interpolation=cv2.INTER_CUBIC)
    return np.clip(img, 0, 1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Whole-image scenes in NIND's layout (``<set>/NIND_<set>_ISO<n>``):
    S1 176 x 208 with a PNG and a JPEG noisy image, S2 200 x 260, and T,
    40 x 50, below the minimum tiling."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    for aset, (h, w), noisy in (("S1", (176, 208), (("ISO800", ".png"), ("ISO3200", ".jpg"))),
                                ("S2", (200, 260), (("ISO6400", ".png"),)),
                                ("T", (40, 50), (("ISO1600", ".png"),))):
        d = root / ("tiny" if aset == "T" else "scenes") / aset
        d.mkdir(parents=True)
        clean = _smooth(rng, h, w)
        cv2.imwrite(str(d / f"NIND_{aset}_ISO100.png"), (clean * 65535).astype(np.uint16))
        for iso, ext in noisy:
            img = np.clip(clean + rng.normal(0, 0.05, clean.shape), 0, 1)
            u = (img * 255).astype(np.uint8) if ext == ".jpg" else (img * 65535).astype(np.uint16)
            cv2.imwrite(str(d / f"NIND_{aset}_{iso}{ext}"), u)
    return root


@contextlib.contextmanager
def _float32():
    """Both packages' denoise_dir in float32."""
    with pytest.MonkeyPatch.context() as mp:
        res, make = jax_engine.resolve_apply_fn, jax_engine.make_engine
        mp.setattr(jax_engine, "resolve_apply_fn",
                   lambda *a, **kw: res(*a, **{**kw, "compute_dtype": "float32"}))
        mp.setattr(jax_engine, "make_engine",
                   lambda *a, **kw: make(*a, **{**kw, "compute_dtype": "float32"}))
        mp.setattr(port_dd, "AdaptiveEngine", functools.partial(
            port_engine.AdaptiveEngine, compute_dtype="float32"))
        mp.setattr(port_dd, "make_engine", functools.partial(
            port_engine.make_engine, compute_dtype="float32"))
        yield


def _checkpoint(d):
    """A funit-8 checkpoint of its own under ``d``: denoise_dir writes its
    JSON files beside it."""
    (d / "model").mkdir(parents=True)
    path = str(d / "model" / "generator_5.npz")
    fixtures.write_jax_checkpoint(path, 8, seed=11)
    return path


def _run_both(tree, run, extra):
    """(jax overall, port overall) of one denoise_dir run on each side, in
    ``<tree>/<side>/<run>``."""
    out = []
    for side, mod, flag in (("jax", jax_dd, ["--devices", "1"]),
                            ("port", port_dd, ["--device", "cpu"])):
        d = tree / side / run
        out.append(mod.main(["--model_path", _checkpoint(d), *COMMON,
                             "--result_dir", str(d / "results"), *extra, *flag]))
    return tuple(out)


# name -> extra argv; every run but bf16 in float32
RUNS = {
    "scored": lambda t: ["--noisy_dir", str(t / "scenes")],
    "tiny_no_scoring": lambda t: ["--noisy_dir", str(t / "tiny"), "--no_scoring"],
    "whole_test_reserve": lambda t: ["--test_reserve", "S1", "--orig_data",
                                     str(t / "scenes"), "--whole_image", "--pad", "16"],
    "bf16": lambda t: ["--test_reserve", "S2", "--orig_data", str(t / "scenes")],
}


@pytest.fixture(scope="module")
def runs(tree):
    with _float32():
        return {name: _run_both(tree, name, RUNS[name](tree))
                for name in RUNS if name != "bf16"}


@pytest.fixture(scope="module")
def bf16_run(tree):
    return _run_both(tree, "bf16", RUNS["bf16"](tree))


def _images(tree, run):
    """{path under the run's directory: [jax pixels, port pixels]}."""
    out = {}
    for side in ("jax", "port"):
        d = tree / side / run
        for p, _, fs in sorted(os.walk(d)):
            for f in sorted(fs):
                if f.endswith((".png", ".tif")):
                    rel = os.path.relpath(os.path.join(p, f), d)
                    out.setdefault(rel, []).append(
                        cv2.imread(os.path.join(p, f), cv2.IMREAD_UNCHANGED))
    return out


def _assert_close_dicts(got, ref, tol=JSON_TOL):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_close_dicts(got[k], ref[k], tol)
        elif isinstance(ref[k], float):
            assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("run", ["scored", "tiny_no_scoring", "whole_test_reserve"])
def test_denoise_dir_float32_matches_jax(tree, runs, run):
    jax_overall, port_overall = runs[run]
    images = _images(tree, run)
    expected = {"scored": {"results/model/NIND_S1_ISO800.png",
                           "results/model/NIND_S1_ISO3200.jpg.tif",
                           "results/model/NIND_S2_ISO6400.png"},
                "tiny_no_scoring": {"results/model/NIND_T_ISO1600.png"},
                "whole_test_reserve": {
                    "model/test/generator_5.npz/['S1']/NIND_S1_ISO800.png",
                    "model/test/generator_5.npz/['S1']/NIND_S1_ISO3200.jpg.tif"}}[run]
    assert set(images) == expected
    for rel, (ref, got) in images.items():
        assert got.dtype == ref.dtype == np.uint16 and got.shape == ref.shape, rel
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (rel, diff.max())
        assert 0 < ref.mean() < 65535 and len(np.unique(ref)) > 100, rel  # not clamped
    if run == "tiny_no_scoring":
        assert jax_overall == port_overall == {}
    else:
        assert set(port_overall) == {"mse", "ssim", "msssim"}
        _assert_close_dicts(port_overall, jax_overall)
    for fn in ("trainres.json", "testres.json"):
        ref = json.loads((tree / "jax" / run / "model" / fn).read_text())
        got = json.loads((tree / "port" / run / "model" / fn).read_text())
        _assert_close_dicts(got, ref)


def test_legacy_res_txt_matches_jax(tree, runs):
    rows = {}
    for side in ("jax", "port"):
        lines = (tree / side / "scored" / "results" / "model" / "res.txt").read_text().splitlines()
        rows[side] = [line.split(",") for line in lines]
    assert rows["port"][0] == rows["jax"][0] == ["filename", "ssim", "mse"]
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]
    assert len(rows["port"]) == 3  # S1's two outputs; S2's is another shape
    for got, ref in zip(rows["port"][1:], rows["jax"][1:]):
        np.testing.assert_allclose(float(got[1]), float(ref[1]), atol=JSON_TOL)
        np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=TOL["mse"][1])


def test_denoise_dir_bf16_matches_jax_bf16(tree, bf16_run):
    jax_overall, port_overall = bf16_run
    (rel, (ref, got)), = _images(tree, "bf16").items()
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= BF16_LSB and (diff == 0).mean() >= BF16_EQUAL, \
        (rel, diff.max(), (diff == 0).mean())
    for k in ("mse", "ssim", "msssim"):
        assert abs(port_overall[k] - jax_overall[k]) <= BF16_SCORE, k


def test_denoise_dir_skip_existing_decodes_and_denoises_nothing(tree, tmp_path, monkeypatch):
    """A second run over complete outputs decodes no input and runs no
    engine, and scores the files it finds exactly as the first run scored
    the pixels it had just written."""
    argv = ["--model_path", _checkpoint(tmp_path), *COMMON, "--noisy_dir",
            str(tree / "scenes"), "--result_dir", str(tmp_path / "results"),
            "--device", "cpu", "--skip_existing"]
    first = port_dd.main(argv)
    calls = []
    monkeypatch.setattr(imgio, "load_img_raw", lambda p: calls.append(p))

    class NoEngine:
        def __init__(self, *a, **kw):
            pass

        def denoise_raw(self, *a, **kw):
            raise AssertionError("denoised a skipped image")

    monkeypatch.setattr(port_dd, "AdaptiveEngine", NoEngine)
    assert port_dd.main(argv) == first
    assert calls == []


@pytest.mark.parametrize("extra,exc,match", [
    (["--network", "DnCNN", "--noisy_dir", "."], ValueError, "unsupported generator"),
    (["--network", "HuNet", "--noisy_dir", "."], ValueError, "unsupported generator"),
    (["--test_reserve"], SystemExit, "noisy_dir"),
    (["--test_reserve", "S1"], SystemExit, "orig_data"),
])
def test_denoise_dir_refuses(tmp_path, monkeypatch, extra, exc, match):
    argv = ["--model_path", _checkpoint(tmp_path), "--network", "UtNet",
            "--cs", "104", "--ucs", "88", "--device", "cpu"]
    with pytest.raises(exc, match=match):
        port_dd.main(argv + extra)


@pytest.mark.parametrize("how", ["devices_2", "world_size_2"])
def test_denoise_dir_runs_on_two_devices_and_as_a_second_process(tree, tmp_path,
                                                                 monkeypatch, how):
    """``--devices 2``: every output within 1 LSB of the one-device run, the
    same scores within 1e-5 (bf16 in both). ``WORLD_SIZE=2`` with torchrun's
    variables, as the second process (the group and its all-gather stood in
    for by a first process whose shard scored nothing): the odd images of
    each set only, their mean as the set's, and no record written."""
    argv = ["--model_path", _checkpoint(tmp_path), *COMMON, "--device", "cpu",
            "--noisy_dir", str(tree / "scenes")]
    one = port_dd.main(argv + ["--result_dir", str(tmp_path / "one")])
    if how == "devices_2":
        two = port_dd.main(argv + ["--result_dir", str(tmp_path / "two"), "--devices", "2"])
        for k in one:
            assert abs(two[k] - one[k]) <= 1e-5, k
        for fn in os.listdir(tmp_path / "one" / "model"):
            if fn.endswith((".png", ".tif")):
                a, b = (cv2.imread(str(tmp_path / d / "model" / fn), cv2.IMREAD_UNCHANGED)
                        for d in ("one", "two"))
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, fn
        return
    from nind_denoise_tpu_torch.parallel import mesh

    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29511"),
                 ("WORLD_SIZE", "2"), ("RANK", "1")):
        monkeypatch.setenv(k, v)
    joined = []
    monkeypatch.setattr(mesh, "init_distributed", lambda *a, **kw: joined.append(1) or True)
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setattr(mesh, "process_index", lambda: 1)
    monkeypatch.setattr(mesh, "process_allgather",
                        lambda local: np.stack([np.zeros(4), np.asarray(local, float)]))
    os.remove(tmp_path / "model" / "testres.json")
    got = port_dd.main(argv + ["--result_dir", str(tmp_path / "second")])
    assert joined == [1]
    written = sorted(os.listdir(tmp_path / "second" / "model"))
    assert written == ["NIND_S1_ISO800.png"]  # S1's second image; S2 has one
    assert not (tmp_path / "model" / "testres.json").exists()
    assert set(got) == {"mse", "ssim", "msssim"}


def _float64_losses(a, b):
    """1 - SSIM and 1 - MS-SSIM of ``ops/losses.py``'s formulas in float64."""
    k = port_losses.gaussian_kernel().double()

    def blur(x):
        c, n = x.shape[1], k.numel()
        x = F.conv2d(x, k.view(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
        return F.conv2d(x, k.view(1, 1, 1, n).expand(c, 1, 1, n), groups=c)

    def ssim_cs(x, y):
        mx, my = blur(x), blur(y)
        vx, vy, cov = blur(x * x) - mx * mx, blur(y * y) - my * my, blur(x * y) - mx * my
        cs = (2 * cov + 0.03 ** 2) / (vx + vy + 0.03 ** 2)
        ss = (2 * mx * my + 0.01 ** 2) / (mx ** 2 + my ** 2 + 0.01 ** 2) * cs
        return ss.mean((2, 3)), cs.mean((2, 3))

    ssim = float(ssim_cs(a, b)[0].mean())
    css = []
    for i in range(5):
        if i:
            a, b = avgpool2x_ceil(a), avgpool2x_ceil(b)
        ss, cs = ssim_cs(a, b)
        css.append(torch.relu(cs))
    stack = torch.stack(css[:-1] + [torch.relu(ss)], -1)
    w = torch.tensor(port_losses.MS_SSIM_WEIGHTS, dtype=torch.float64)
    return 1 - ssim, 1 - float(torch.prod(stack ** w, -1).mean())


@pytest.mark.parametrize("noisy", ["scenes/S1/NIND_S1_ISO800.png",
                                   "jax/scored/results/model/NIND_S1_ISO3200.jpg.tif"])
def test_file_scores_match_jax(tree, runs, noisy):
    """A noisy input and a denoised output against S1's baseline."""
    a, b = str(tree / "scenes" / "S1" / "NIND_S1_ISO100.png"), str(tree / noisy)
    ref, got = jax_score.get_losses(a, b), port_score.get_losses(a, b, device="cpu")
    for k, (atol, rtol) in TOL.items():
        np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=rtol, err_msg=k)
    pair = [port_score.to_device(imgio.load_img(p), "cpu") for p in (a, b)]
    assert got == {"mse": float(port_losses.mse_loss(*pair)[0]),  # one pass, same bits
                   "ssim": float(port_losses.ssim_loss(*pair)[0]),
                   "msssim": float(port_losses.ms_ssim_loss(*pair)[0])}
    ssim64, msssim64 = _float64_losses(*(t.double() for t in pair))
    assert abs(got["ssim"] - ssim64) <= 2e-7 and abs(got["msssim"] - msssim64) <= 2e-7
    np.testing.assert_allclose(port_score.msssim_files(a, b, device="cpu"),
                               jax_score.msssim_files(a, b), atol=TOL["msssim"][0])
    np.testing.assert_allclose(port_score.psnr_files(a, b, device="cpu"),
                               jax_score.psnr_files(a, b), rtol=1e-6)
    # pixels held in memory score as the file they were written to
    u16 = cv2.cvtColor(cv2.imread(b, cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB)
    base = port_score.to_device(imgio.load_img(a), "cpu")
    assert port_score.losses(base, port_score.to_device(u16, "cpu")) == got
    with pytest.raises(ValueError, match="162"):
        port_score.get_losses(*[str(tree / "tiny" / "T" / f"NIND_T_{i}.png")
                                for i in ("ISO100", "ISO1600")], device="cpu")


def test_grapher_matches_jax(tmp_path):
    for exp, rows in (("exp1", [("NIND_a_ISO200.png", 0.1, 0.001),
                                ("NIND_a_ISO3200.png", 0.3, 0.004),
                                ("NIND_a_ISOH1.png", 0.5, 0.01)]),
                      ("exp2/sub", [("NIND_b_ISO200-2.jpg.tif", 0.2, 0.002),
                                    ("no_iso.png", 0.4, 0.1), ("bad", "x")])):
        d = tmp_path / "results" / exp
        d.mkdir(parents=True)
        (d / ("res.txt" if exp == "exp1" else "res.csv")).write_text(
            "filename,ssim,mse\n" + "\n".join(",".join(map(str, r)) for r in rows) + "\n")
    root = str(tmp_path / "results")
    files = port_grapher.find_res_files(root)
    assert files == jax_grapher.find_res_files(root) and len(files) == 2
    for f in files:
        assert port_grapher.parse_res_file(f) == jax_grapher.parse_res_file(f)
    out = port_grapher.main([root, "-o", str(tmp_path / "g.png"), "--metric", "mse"])
    assert cv2.imread(out) is not None


def test_scoring_then_training_backward():
    """Scoring runs under no_grad, not inference_mode: the MS-SSIM weights
    it caches on the device stay usable by a later training step."""
    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy(rng.random((1, 3, 170, 170), np.float32)) for _ in range(2))
    port_score.losses(x, y)
    x.requires_grad_()
    port_losses.ms_ssim_loss(x, y).mean().backward()
    assert torch.isfinite(x.grad).all()


def test_denoise_dir_unet_matches_jax(tree, tmp_path):
    """``--network UNet`` over the test reserve S2 in float32: the output
    within 1 LSB of JAX's with at least 95 % equal (seen 98 %: the
    full-width UNet's fp32 outputs lie ~1e-6 apart, tests/test_torch_unet.py,
    a fifteenth of a uint16 LSB, against ~1e-7 for UtNet funit 8 above),
    ``overall`` within ``JSON_TOL``."""
    out = []
    with _float32():
        for side, mod, flag in (("jax", jax_dd, ["--devices", "1"]),
                                ("port", port_dd, ["--device", "cpu"])):
            d = tmp_path / side
            (d / "model").mkdir(parents=True)
            ck = str(d / "model" / "generator_5.npz")
            fixtures.write_unet_checkpoint(ck, seed=9)
            out.append(mod.main(["--model_path", ck, "--network", "UNet", "--cs", "104",
                                 "--ucs", "88", "--batch_size", "4", "--test_reserve", "S2",
                                 "--orig_data", str(tree / "scenes"), *flag]))
    rel = os.path.join("model", "test", "generator_5.npz", "['S2']", "NIND_S2_ISO6400.png")
    ref, got = (cv2.imread(str(tmp_path / side / rel), cv2.IMREAD_UNCHANGED)
                for side in ("jax", "port"))
    assert got.dtype == ref.dtype == np.uint16 and got.shape == ref.shape == (200, 260, 3)
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.95, (diff.max(), (diff == 0).mean())
    _assert_close_dicts(out[1], out[0])
