"""The port's TileEngine against the JAX TileEngine, both in fp32 on the
CPU: the stitching-adversarial shape sweep of tests/test_golden_e2e.py,
storage-dtype inputs with quantized outputs, and the tiny-image path."""

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
ATOL, RTOL = 5e-5, 1e-4  # fp32, as tests/test_golden_e2e.py


@pytest.fixture(scope="module")
def engines():
    params = JaxUtNet.init(jax.random.PRNGKey(11), funit=8)
    model = UtNet(8)
    model.load_state_dict(params_io.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    kw = dict(cs=CS, ucs=UCS, ol=OL, batch_size=3, compute_dtype="float32",
              precision="float32")
    jax_eng = jte.make_engine("UtNet", params, **kw)
    port_eng = tte.make_engine("UtNet", model, device="cpu", **kw)
    return jax_eng, port_eng


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((a - b) ** 2))


def _shapes():
    stride = UCS - OL
    rng = np.random.default_rng(6)
    shapes = [(UCS, UCS), (CS, CS), (UCS + stride, UCS + stride),
              (UCS + stride - 1, UCS + stride + 1), (60, 260), (260, 60)]
    return shapes + [tuple(int(v) for v in rng.integers(55, 280, 2))
                     for _ in range(3)]


@pytest.mark.parametrize("hw", _shapes())
def test_engine_matches_jax_across_shapes(engines, hw):
    jax_eng, port_eng = engines
    img = np.random.default_rng(hw[0] * 1000 + hw[1]).random(
        (3, *hw), dtype=np.float32)
    ref = jax_eng.denoise_chw(img)
    got = port_eng.denoise_chw(img)
    assert got.shape == ref.shape == img.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert _psnr(got, ref) > 80


@pytest.mark.parametrize("dtype,scale", [(np.uint8, 255.0), (np.uint16, 65535.0)])
def test_engine_raw_inputs_and_outputs(engines, dtype, scale):
    jax_eng, port_eng = engines
    rng = np.random.default_rng(7)
    raw = rng.integers(0, int(scale) + 1, (150, 170, 3)).astype(dtype)
    ref = jax_eng.denoise_raw(raw, scale, out_dtype="float32")
    got = port_eng.denoise_raw(raw, scale, out_dtype="float32")
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert _psnr(got, ref) > 80
    for out in ("uint16", "uint8"):
        r = jax_eng.denoise_raw(raw, scale, out_dtype=out)
        g = port_eng.denoise_raw(raw, scale, out_dtype=out)
        assert g.dtype == r.dtype
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
    dev = port_eng.denoise_raw(raw, scale, out_dtype="device")
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), got)


def test_denoise_tiny(engines):
    jax_eng, port_eng = engines
    raw = np.random.default_rng(8).integers(0, 65536, (40, 50, 3)).astype(np.uint16)
    ref = jax_eng.denoise_tiny(raw, 65535.0, out_dtype="float32")
    got = port_eng.denoise_tiny(raw, 65535.0, out_dtype="float32")
    assert got.shape == (40, 50, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    r8 = jax_eng.denoise_tiny(raw, 65535.0, out_dtype="uint8")
    g8 = port_eng.denoise_tiny(raw, 65535.0, out_dtype="uint8")
    assert np.abs(g8.astype(int) - r8.astype(int)).max() <= 1


def test_max_subpixels_guard(engines):
    _, port_eng = engines
    eng = tte.TileEngine(port_eng.apply_fn, CS, UCS, max_subpixels=1000,
                         device="cpu")
    with pytest.raises(RuntimeError):
        eng.denoise_raw(np.zeros((120, 120, 3), np.uint8), 255.0)


def test_unported_configurations_raise():
    with pytest.raises(NotImplementedError):
        tte.resolve_apply_fn("UNet", UtNet(4), device="cpu")
    with pytest.raises(NotImplementedError):
        tte.resolve_apply_fn("UtNet", UtNet(4), compute_dtype="int8", device="cpu")
