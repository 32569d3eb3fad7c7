"""The port's int8 UtNet (``models/utnet_int8.QuantUtNet``), its engine
modes and its CLIs against the JAX package on the CPU, at funit 8: the
derived int8 weights and scales against ``UtNet.precompute_int8`` (the
folded kernels and the level-4 parity scales included), the calibrated
static scales against ``calibrate_int8``, the dynamic and static forwards
against ``apply_int8`` (fp32 work dtype), the PSNR floors of
tests/test_qconv.py against the port's own fp32 forward, odd sizes, the
engine modes with per-image recalibration, ``AdaptiveEngine``'s policy for
int8_static, and the CLIs' pre-encode uint8 against the JAX CLIs'."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nind_denoise_tpu.models.utnet import UtNet as JaxUtNet
from nind_denoise_tpu.ops import fastconv as JF
from nind_denoise_tpu.ops import qconv as JQ
from nind_denoise_tpu.pipeline import denoise_cli as jax_cli
from nind_denoise_tpu.pipeline import denoise_image_cli as jax_image_cli
from nind_denoise_tpu_torch.engine import tile_engine as tte
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.models.utnet_int8 import QuantUtNet
from nind_denoise_tpu_torch.ops import compose, enc1, qconv as Q
from nind_denoise_tpu_torch.pipeline import denoise_cli as port_cli
from nind_denoise_tpu_torch.pipeline import denoise_image_cli as port_image_cli
from nind_denoise_tpu_torch.tools import fixtures


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch's default threads under the fast tier's parallel workers
    oversubscribe the host: two a worker, as test_torch_train_gan_cli.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 10 * np.log10(1.0 / max((d ** 2).mean(), 1e-20))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """One seeded funit-8 checkpoint on both sides, JAX's derived int8
    tree, its calibrated scales, and one JAX forward per mode."""
    path = str(tmp_path_factory.mktemp("ckpt") / "generator_1.npz")
    fixtures.write_jax_checkpoint(path, 8, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, params_io.load_npz(path))
    model = params_io.load_generator(path, "UtNet", "PReLU")
    derived = jax.jit(JaxUtNet.precompute_int8)(jp)
    d_static = JaxUtNet.calibrate_int8(jp, derived, JQ.calib_tiles())
    x = np.random.default_rng(0).random((2, 136, 136, 3), dtype=np.float32)
    fwd = jax.jit(lambda d, t: JaxUtNet.apply_int8(jp, t, derived=d))
    return dict(path=path, jp=jp, model=model, derived=derived, d_static=d_static, x=x,
                ref_dynamic=np.asarray(fwd(derived, jnp.asarray(x))),
                ref_static=np.asarray(fwd(d_static, jnp.asarray(x))))


def _int8_weights(q):
    """{site: (HWIO int8 kernel, scales)} as numpy."""
    return {k: (q.qweight(k)[0].permute(1, 2, 3, 0).numpy(), q.qweight(k)[1].numpy())
            for k in q.sites}


def _port(q, x_nhwc):
    with torch.inference_mode():
        y = q(torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).float().numpy()


@pytest.fixture(scope="module")
def quant(setup):
    dyn = QuantUtNet(setup["model"], device="cpu")
    stat = QuantUtNet(setup["model"], static=True, device="cpu")
    stat.calibrate(Q.calib_tiles())
    return dyn, stat


def test_int8_weights_equal_precompute_int8(setup, quant):
    """Codes and scales against JAX's derived tree. The composed kernels'
    fp32 sums may round in another order, which can move a rare code by 1:
    counted, at most 1 in 10^4. Scales within 1e-6 relative. The folded
    3x3 kernels (enc1's c1, level 4's skip and c1) are the port's codes
    placed by ``fold_kernel``, with the port's scales tiled: every folded
    output phase sees all nine taps."""
    d = setup["derived"]
    off = total = 0
    for key, (w, s) in _int8_weights(quant[0]).items():
        jw, js = np.asarray(d[key]["w"]), np.asarray(d[key]["s"])
        if key == "K3fq":
            continue  # test_level4_parity_scales
        if key in ("enc1_c1fq", "w3b4q", "dec4_c1q"):
            np.testing.assert_array_equal(np.asarray(JF.fold_kernel(jnp.asarray(w))), jw)
            np.testing.assert_allclose(np.tile(s, 2), js, rtol=1e-6)
            continue
        assert w.shape == jw.shape, key
        assert np.abs(w.astype(int) - jw.astype(int)).max() <= 1, key
        off += int((w != jw).sum())
        total += w.size
        np.testing.assert_allclose(s, js, rtol=1e-6, err_msg=key)
    assert off <= total * 1e-4, (off, total)


def test_level4_parity_scales(setup, quant):
    """The unfolded level-4 composed conv carries K3fq's scales: JAX's
    folded output phase v is the port's output column parity 1 - v, and
    its folded taps are the port's tap columns of that parity."""
    w, s = _int8_weights(quant[0])["K3fq"]
    jw = np.asarray(setup["derived"]["K3fq"]["w"])
    js = np.asarray(setup["derived"]["K3fq"]["s"])
    cout = w.shape[3]
    assert s.shape == (2, cout)
    np.testing.assert_allclose(s, js.reshape(2, cout)[::-1], rtol=1e-6)
    off = 0
    for a in range(4):
        for t in range(3):
            for v in (0, 1):
                b = 2 * t - v  # JAX's folded tap (a, t) of phase v
                want = jw[a, t, :, v * cout:(v + 1) * cout]
                got = w[a, b] if 0 <= b <= 3 else np.zeros_like(want)
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
                off += int((got != want).sum())
    assert off <= w.size * 1e-4


def test_calibrated_scales_equal_calibrate_int8(setup, quant):
    ref = setup["d_static"]["acts"]
    got = quant[1].acts
    assert sorted(got) == sorted(ref) and len(got) >= 14
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_forward_matches_apply_int8(setup, quant, mode):
    """fp32 work dtype on both sides; the same codes except where a sum
    order flips a rounding. Measured 109.5 dB (dynamic) and 167.5 dB
    (static) on this fixture; floor 60 dB."""
    q = quant[0] if mode == "dynamic" else quant[1]
    got = _port(q, setup["x"])
    ref = setup[f"ref_{mode}"]
    assert got.shape == ref.shape
    assert _psnr(got, ref) >= 60.0, _psnr(got, ref)


def test_psnr_floors_against_the_fp32_forward(setup, quant):
    """tests/test_qconv.py's floors, on the port against its own fp32
    forward: 58 dB dynamic, 54 dB static; bf16 work dtype 52 / 50."""
    x = setup["x"][:1]
    with torch.inference_mode():
        ref = setup["model"](torch.from_numpy(x).permute(0, 3, 1, 2)) \
            .permute(0, 2, 3, 1).numpy()
    for q, floor, floor16 in ((quant[0], 58.0, 52.0), (quant[1], 54.0, 50.0)):
        assert _psnr(_port(q, x), ref) >= floor
        with torch.inference_mode():
            y16 = q(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
        assert _psnr(y16.float().permute(0, 2, 3, 1).numpy(), ref) >= floor16


def test_calib_from_image_wins_on_dim_content(setup):
    """Dim content (6% of range): scales from the image's own crops beat
    the synthetic set and reach tests/test_qconv.py's 68 dB floor.
    Measured 74.5 dB against 72.0 dB on this fixture."""
    x = np.random.default_rng(0).random((136, 136, 3), dtype=np.float32) * 0.06
    with torch.inference_mode():
        ref = setup["model"](torch.from_numpy(x[None]).permute(0, 3, 1, 2)) \
            .permute(0, 2, 3, 1).numpy()
    q = QuantUtNet(setup["model"], static=True, device="cpu")
    q.calibrate(Q.calib_tiles())
    p_syn = _psnr(_port(q, x[None]), ref)
    q.calibrate(Q.calib_from_image(x))
    p_img = _psnr(_port(q, x[None]), ref)
    assert p_img > p_syn and p_img >= 68.0, (p_img, p_syn)


def test_odd_sizes_take_the_exact_forward(quant, monkeypatch):
    """Odd H or W dispatch to the exact float forward, decided from the
    shape (no engine tile size is odd), as ``apply_int8`` falls back to
    ``apply``."""
    sentinel = torch.zeros(1)
    for q in quant:
        monkeypatch.setattr(q, "_exact_forward", lambda x: sentinel)
        assert q(torch.zeros(1, 3, 137, 136)) is sentinel
        assert q(torch.zeros(1, 3, 136, 137)) is sentinel
        assert q(torch.zeros(1, 3, 104, 104)) is not sentinel


def test_static_needs_calibration_and_even_calibration_sizes(setup):
    q = QuantUtNet(setup["model"], static=True, device="cpu")
    with pytest.raises(RuntimeError, match="calibrate"):
        _port(q, np.zeros((1, 104, 104, 3), np.float32))
    with pytest.raises(ValueError, match="even"):
        q.calibrate(np.zeros((2, 135, 136, 3), np.float32))


def test_forward_takes_k2_in_dynamic_mode_only(setup, quant, monkeypatch):
    """Level 1 of the dynamic mode goes through enc1 (K2's wrapper); the
    static mode runs its c1 in int8 instead."""
    calls = []
    real = enc1.enc1
    monkeypatch.setattr(enc1, "enc1", lambda *a: calls.append(1) or real(*a))
    x = setup["x"][:1]
    _port(quant[0], x)
    assert calls == [1]
    _port(quant[1], x)
    assert calls == [1]


def test_bias_map_equals_jax(setup):
    m = setup["model"]
    from nind_denoise_tpu_torch.models.utnet_int8 import tconv_hwio

    w3 = tconv_hwio(m.tconvs2[0])
    cmid = m.up2.weight.shape[1]
    b = m.up2.bias.detach()
    ref = np.asarray(JF.up_bias_map(12, 10, jnp.asarray(b.numpy()),
                                    jnp.asarray(w3[:, :, :cmid].numpy()), jnp.float32))
    got = compose.up_bias_map(12, 10, compose.bias_taps(b, w3[:, :, :cmid])).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


# -- the engine modes ---------------------------------------------------------


def _raw(h=200, w=260, seed=0):
    return np.random.default_rng(seed).integers(0, 65536, (h, w, 3), dtype=np.uint16)


def test_engine_modes_meet_the_floors(setup):
    """make_engine int8 / int8_static against the fp32 engine (uint16 in,
    fp32 out), tests/test_qconv.py's floors: 45 and 42 dB."""
    img = _raw()
    kw = dict(cs=104, ucs=88, batch_size=4, device="cpu")
    ref = tte.make_engine("UtNet", setup["model"], compute_dtype="float32",
                          precision="float32", **kw).denoise_raw(img, 65535.0)
    for mode, floor in (("int8", 45.0), ("int8_static", 42.0)):
        eng = tte.make_engine("UtNet", setup["model"], compute_dtype=mode, **kw)
        assert eng.compute_dtype == torch.bfloat16  # bf16 tile I/O
        out = eng.denoise_raw(img, 65535.0)
        assert _psnr(out, ref) >= floor, (mode, _psnr(out, ref))


def test_recalibrate_int8_per_image(setup):
    img = _raw(seed=1)
    kw = dict(cs=104, ucs=88, batch_size=4, device="cpu")
    eng = tte.make_engine("UtNet", setup["model"], compute_dtype="int8_static", **kw)
    before = {k: float(v) for k, v in eng.apply_fn.acts.items()}
    assert eng.recalibrate_int8(img, 65535.0)
    want = QuantUtNet(setup["model"], static=True, device="cpu") \
        .calibrate(Q.calib_from_image(img, scale=65535.0))
    after = {k: float(v) for k, v in eng.apply_fn.acts.items()}
    assert after == {k: float(v) for k, v in want.items()} and after != before
    dyn = tte.make_engine("UtNet", setup["model"], compute_dtype="int8", **kw)
    assert not dyn.recalibrate_int8(img, 65535.0)


def test_adaptive_int8_static_recalibrates_and_never_coalesces(setup, monkeypatch):
    """AdaptiveEngine in int8_static: each request recalibrates on its own
    image first, and a same-shape group runs per image (no coalesced
    ``TileEngine.denoise_many``), each equal to its own run."""
    ada = tte.AdaptiveEngine("UtNet", setup["model"], cs=104, ucs=88, batch_size=4,
                             compute_dtype="int8_static", device="cpu")
    imgs = [_raw(60, 70, seed=s) for s in (2, 3)]
    singles = [ada.denoise_raw(im, 65535.0) for im in imgs]
    want = QuantUtNet(setup["model"], static=True, device="cpu") \
        .calibrate(Q.calib_from_image(imgs[1], scale=65535.0))
    assert {k: float(v) for k, v in ada._resolved.acts.items()} == \
        {k: float(v) for k, v in want.items()}
    monkeypatch.setattr(tte.TileEngine, "denoise_many",
                        lambda *a, **k: pytest.fail("coalesced an int8_static group"))
    got = ada.denoise_many(imgs, 65535.0)
    for g, s in zip(got, singles):
        np.testing.assert_array_equal(g, s)


def test_adaptive_int8_coalesces_like_bf16(setup, monkeypatch):
    ada = tte.AdaptiveEngine("UtNet", setup["model"], cs=104, ucs=88, batch_size=4,
                             compute_dtype="int8", device="cpu")
    calls = []
    real = tte.TileEngine.denoise_many
    monkeypatch.setattr(tte.TileEngine, "denoise_many",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    imgs = [_raw(60, 70, seed=s) for s in (4, 5)]
    got = ada.denoise_many(imgs, 65535.0)
    assert calls == [1] and got.shape == (2, 60, 70, 3)


# -- the CLIs against the JAX CLIs ---------------------------------------------


def _capture(monkeypatch):
    seen = {"jax": [], "port": []}
    for side, mod in (("jax", jax_cli), ("port", port_cli)):
        encode = mod._encode_u8

        def spy(u8, path, quality, _side=side, _encode=encode):
            seen[_side].append(np.array(u8))
            _encode(u8, path, quality)

        monkeypatch.setattr(mod, "_encode_u8", spy)
    monkeypatch.setattr(jax_image_cli, "_resolve_devices", lambda args: 1)
    return seen


def _tiff(path, seed=2, hw=(120, 140)):
    img = (np.random.default_rng(seed).random((*hw, 3)) * 65535).astype(np.uint16)
    assert cv2.imwrite(str(path), img)
    return str(path)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_denoise_cli_matches_jax(tmp_path, monkeypatch, setup, mode):
    """``denoise --tiff-input --compute_dtype int8|int8_static`` on both
    sides, bf16 work dtype as the JAX engine runs it: within 2 LSB
    everywhere and >= 99.9 % of the pixels within 1 LSB. Measured: max 1
    LSB; 96.8 % (int8) and 99.98 % (int8_static) of the pixels equal."""
    jax_engine_cache = dict(jax_cli._ENGINE_CACHE)
    jax_cli._ENGINE_CACHE.clear()
    seen = _capture(monkeypatch)
    tif = _tiff(tmp_path / "img.tif")
    argv = [tif, "--tiff-input", "--model_path", setup["path"], "--cs", "104",
            "--ucs", "88", "--batch_size", "2", "--compute_dtype", mode]
    try:
        for side, cli in (("jax", jax_cli), ("port", port_cli)):
            out = tmp_path / side
            out.mkdir()
            cli.main(argv + ["-o", str(out)] + (["--device", "cpu"] if side == "port" else []))
    finally:
        jax_cli._ENGINE_CACHE.clear()
        jax_cli._ENGINE_CACHE.update(jax_engine_cache)
    (ref,), (got,) = seen["jax"], seen["port"]
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert got.shape == ref.shape == (120, 140, 3)
    assert diff.max() <= 2 and (diff <= 1).mean() >= 0.999, (diff.max(), (diff <= 1).mean())


def test_denoise_image_cli_int8_static_calibrates_on_the_input(tmp_path, setup, monkeypatch):
    """``denoise_image --compute_dtype int8_static`` builds its engine's
    scales from ``calib_from_image`` of the input, as the JAX CLI does."""
    tif = _tiff(tmp_path / "img.tif", seed=6)
    got = []
    real = tte.resolve_apply_fn
    monkeypatch.setattr(tte, "resolve_apply_fn",
                        lambda *a, **k: got.append(k.get("calib")) or real(*a, **k))
    out = str(tmp_path / "o.tif")
    port_image_cli.main(["-i", tif, "-o", out, "--network", "UtNet", "--model_path",
                         setup["path"], "--cs", "104", "--ucs", "88",
                         "--compute_dtype", "int8_static", "--device", "cpu",
                         "--exif_method", "noexif"])
    raw = cv2.cvtColor(cv2.imread(tif, cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got[0], Q.calib_from_image(raw, scale=65535.0))
    assert cv2.imread(out, cv2.IMREAD_UNCHANGED).shape == (120, 140, 3)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_denoise_image_cli_whole_image_int8_matches_jax(tmp_path, setup, monkeypatch, mode):
    """``denoise_image --whole_image --pad 8 --compute_dtype int8|int8_static``
    on one device runs in both CLIs (int8_static calibrated on crops of the
    whole input): the written image, as 8-bit, within 2 LSB of the JAX
    CLI's everywhere and >= 99.9 % of the values within 1 LSB, the int8
    CLI's tolerance."""
    from nind_denoise_tpu.core import imgio as jax_imgio
    from nind_denoise_tpu_torch.core import imgio as port_imgio

    seen = {}
    for side, mod in (("jax", jax_imgio), ("port", port_imgio)):
        save = mod.save_img

        def spy(img, path, *a, _side=side, _save=save, **k):
            seen[_side] = np.array(img, np.float32)
            return _save(img, path, *a, **k)

        monkeypatch.setattr(mod, "save_img", spy)
    calibs = []
    real = tte.resolve_apply_fn
    monkeypatch.setattr(tte, "resolve_apply_fn",
                        lambda *a, **k: calibs.append(k.get("calib")) or real(*a, **k))
    img = (np.random.default_rng(7).random((90, 117, 3)) * 65535).astype(np.uint16)
    src = str(tmp_path / "in.png")
    assert cv2.imwrite(src, img)
    common = ["-i", src, "--network", "UtNet", "--model_path", setup["path"],
              "--cs", "104", "--ucs", "88", "--whole_image", "--pad", "8",
              "--compute_dtype", mode, "--exif_method", "noexif"]
    for side, cli, extra in (("jax", jax_image_cli, ["--devices", "1"]),
                             ("port", port_image_cli, ["--device", "cpu"])):
        cli.main(common + ["-o", str(tmp_path / f"{side}.tif")] + extra)
    if mode == "int8_static":
        whole = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 65535.0
        np.testing.assert_allclose(calibs[-1], Q.calib_from_image(whole), atol=1e-7)
    u8 = {k: np.round(np.clip(v, 0, 1) * 255).astype(int) for k, v in seen.items()}
    assert u8["port"].shape == u8["jax"].shape == (3, 90, 117)
    diff = np.abs(u8["port"] - u8["jax"])
    assert diff.max() <= 2 and (diff <= 1).mean() >= 0.999, (diff.max(), (diff <= 1).mean())
