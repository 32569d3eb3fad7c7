"""The port's cross-image coalescing (TileEngine.denoise_many) and
AdaptiveEngine on the CPU in fp32: bit-equality with the per-image path,
agreement with the JAX engine's denoise_many, and the AdaptiveEngine
policy cases of tests/test_denoise_many.py."""

import numpy as np
import pytest
import torch

import jax

from nind_denoise_tpu.engine import tile_engine as jte
from nind_denoise_tpu.models.utnet import UtNet as JaxUtNet
from nind_denoise_tpu_torch.engine import tile_engine as tte
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.models.utnet import UtNet

CS, UCS, OL = 104, 88, 6
ATOL, RTOL = 5e-5, 1e-4  # fp32, the engine bar of tests/test_torch_engine.py
KW = dict(compute_dtype="float32", precision="float32")


@pytest.fixture(scope="module")
def models():
    params = JaxUtNet.init(jax.random.PRNGKey(3), funit=8)
    model = UtNet(8)
    model.load_state_dict(params_io.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return params, model


@pytest.fixture(scope="module")
def engine(models):
    return tte.make_engine("UtNet", models[1], cs=CS, ucs=UCS, ol=OL, batch_size=4,
                           device="cpu", **KW)


def _imgs(n, h, w, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return [rng.random((h, w, 3), dtype=np.float32) for _ in range(n)]
    return [rng.integers(0, np.iinfo(dtype).max, (h, w, 3), dtype=dtype)
            for _ in range(n)]


def test_group_matches_per_image_and_jax(models, engine):
    imgs = _imgs(3, 150, 170, seed=1)  # 2x2 grid: batches cross images
    got = engine.denoise_many(imgs, 1.0, out_dtype="float32")
    assert got.shape == (3, 150, 170, 3) and got.dtype == np.float32
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(got[i], engine.denoise_raw(im, 1.0))
    jax_eng = jte.make_engine("UtNet", models[0], cs=CS, ucs=UCS, ol=OL,
                              batch_size=4, **KW)
    ref = jax_eng.denoise_many(imgs, 1.0, out_dtype="float32")
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_group_batches_cross_image_boundaries(engine, monkeypatch):
    """2 images x 2 tiles at batch 4 run ONE forward where the per-image
    path needs one per image."""
    shapes = []
    fwd = engine.apply_fn

    def counting(x):
        shapes.append(tuple(x.shape))
        return fwd(x)

    monkeypatch.setattr(engine, "apply_fn", counting)
    imgs = _imgs(2, 88, 150, seed=2)  # one row of 2 tiles each
    got = engine.denoise_many(imgs, 1.0, out_dtype="float32")
    assert shapes == [(4, 3, CS, CS)]
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(got[i], engine.denoise_raw(im, 1.0))


@pytest.mark.parametrize("dtype,scale,out", [(np.uint16, 65535.0, "uint8"),
                                             (np.uint8, 255.0, "uint16"),
                                             (np.float32, 1.0, "float16")])
def test_storage_dtypes_and_quantize(engine, dtype, scale, out):
    imgs = _imgs(2, 120, 140, seed=3, dtype=dtype)
    got = engine.denoise_many(imgs, scale, out_dtype=out)
    assert got.dtype == np.dtype(out) and got.shape == (2, 120, 140, 3)
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(got[i], engine.denoise_raw(im, scale, out_dtype=out))


def test_device_out_dtype_returns_views(engine):
    imgs = _imgs(2, 100, 150, seed=4)
    outs = engine.denoise_many(imgs, 1.0, out_dtype="device")
    assert isinstance(outs, list) and len(outs) == 2
    for o, im in zip(outs, imgs):
        assert isinstance(o, torch.Tensor) and o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), engine.denoise_raw(im, 1.0))


def test_mixed_groups_and_budget_raise(engine, monkeypatch):
    with pytest.raises(ValueError, match="share shape"):
        engine.denoise_many([np.zeros((100, 130, 3), np.float32),
                             np.zeros((100, 131, 3), np.float32)], 1.0)
    with pytest.raises(ValueError, match="share shape"):
        engine.denoise_many([np.zeros((100, 130, 3), np.float32),
                             np.zeros((100, 130, 3), np.uint8)], 1.0)
    assert engine.group_fits(2, 100, 130)
    monkeypatch.setattr(engine, "MAX_GROUP_SUBPIXELS", 1)
    assert not engine.group_fits(2, 100, 130)
    with pytest.raises(ValueError, match="MAX_GROUP_SUBPIXELS"):
        engine.denoise_many(_imgs(2, 100, 130), 1.0)


# -- AdaptiveEngine -----------------------------------------------------------


@pytest.fixture(scope="module")
def adaptive(models):
    return tte.AdaptiveEngine("UtNet", models[1], cs=CS, ucs=UCS, batch_size=8,
                              device="cpu", **KW)


def _count_groups(monkeypatch):
    calls = {"n": 0}
    real = tte.TileEngine.denoise_many

    def counting(self, *a, **kw):
        calls["n"] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(tte.TileEngine, "denoise_many", counting)
    return calls


def test_adaptive_group_coalesces(adaptive, monkeypatch):
    calls = _count_groups(monkeypatch)
    imgs = _imgs(3, 150, 170, seed=6)  # 4 tiles < batch 8
    got = adaptive.denoise_many(imgs, 1.0, out_dtype="float32")
    assert calls["n"] == 1
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(got[i], adaptive.denoise_raw(im, 1.0))


def test_adaptive_full_batches_stay_serial(models, monkeypatch):
    ada = tte.AdaptiveEngine("UtNet", models[1], cs=CS, ucs=UCS, batch_size=4,
                             device="cpu", **KW)
    calls = _count_groups(monkeypatch)
    imgs = _imgs(2, 150, 170, seed=10)  # 4 tiles == batch 4
    got = ada.denoise_many(imgs, 1.0, out_dtype="float32")
    assert calls["n"] == 0
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(got[i], ada.denoise_raw(im, 1.0))


def test_adaptive_mixed_shapes_fall_back(adaptive, monkeypatch):
    calls = _count_groups(monkeypatch)
    imgs = [_imgs(1, 150, 170, seed=7)[0], _imgs(1, 120, 140, seed=8)[0]]
    dev = adaptive.denoise_many(imgs, 1.0, out_dtype="device")
    host = adaptive.denoise_many(imgs, 1.0, out_dtype="float32")
    assert calls["n"] == 0 and isinstance(host, list) and len(host) == 2
    for d, h, im in zip(dev, host, imgs):
        want = adaptive.denoise_raw(im, 1.0)
        np.testing.assert_array_equal(d.numpy(), want)
        np.testing.assert_array_equal(h, want)


def test_adaptive_tiny_falls_back(adaptive, monkeypatch):
    calls = _count_groups(monkeypatch)
    imgs = _imgs(2, 33, 47, seed=9)  # below the minimum tiling
    got = adaptive.denoise_many(imgs, 1.0, out_dtype="float32")
    assert calls["n"] == 0 and got.shape == (2, 33, 47, 3)
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(got[i], adaptive.denoise_raw(im, 1.0))


def test_adaptive_shares_one_resolved_model(models):
    ada = tte.AdaptiveEngine("UtNet", models[1], cs=136, ucs=120, batch_size=2,
                             device="cpu", **KW)
    ada.denoise_raw(_imgs(1, 150, 170, seed=11)[0], 1.0)  # the configured tiles
    ada.denoise_raw(_imgs(1, 60, 64, seed=12)[0], 1.0)  # adapted to 120/104
    ada.denoise_raw(_imgs(1, 33, 47, seed=13)[0], 1.0)  # the tiny engine
    assert set(ada._engines) == {(136, 120), (120, 104), "tiny"}
    assert all(e.apply_fn is ada._resolved for e in ada._engines.values())


def test_adaptive_int8_is_not_ported(models):
    with pytest.raises(NotImplementedError):
        tte.AdaptiveEngine("UtNet", models[1], compute_dtype="int8_static",
                           device="cpu")
