"""The port's Richardson-Lucy deblur against the JAX package on the CPU:
the XLA path (``rl_deblur(impl='xla')``) and the fused Pallas kernel in
interpret mode, HWC and batched NHWC, the short-tail heights, batch
independence, and the gmic uint8 quantize."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nind_denoise_tpu.ops import pallas_blur
from nind_denoise_tpu.ops import rl_deblur as jrl
from nind_denoise_tpu_torch.ops import rl_deblur as trl
from nind_denoise_tpu_torch.ops import rl_fused

# fp32; both sides sum the taps in the same order, the slack covers
# XLA's fusion of multiply-adds
ATOL = RTOL = 2e-5


def _img(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32) + 0.05


# (shape without C, sigma, iterations): HWC images, the short-tail heights
# 361/362 (ADVICE r5), and one batched NHWC input
CASES = [
    ((200, 150), 1.0, 3),
    ((97, 131), 2.0, 3),
    ((130, 260), 3.0, 2),
    ((361, 140), 1.0, 2),
    ((362, 140), 1.0, 2),
    ((2, 60, 90), 2.0, 2),
]


@pytest.mark.parametrize("hw,sigma,iters", CASES)
def test_rl_deblur_matches_xla(hw, sigma, iters):
    img = _img((*hw, 3), 1)
    ref = np.asarray(jrl.rl_deblur(jnp.asarray(img), sigma, iters, impl="xla"))
    got = trl.rl_deblur(torch.from_numpy(img), sigma, iters).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw,sigma,iters", CASES)
def test_rl_deblur_matches_pallas_interpret(hw, sigma, iters):
    img = _img((*hw, 3), 2)
    ref = np.asarray(pallas_blur.rl_deblur_pallas_fused(
        jnp.asarray(img), sigma, iters, interpret=True))
    got = trl.rl_deblur(torch.from_numpy(img), sigma, iters).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_rl_deblur_batched_matches_xla_and_single_runs():
    imgs = _img((3, 40, 56, 3), 3)
    ref = np.asarray(jrl.rl_deblur(jnp.asarray(imgs), 1.0, 3, impl="xla"))
    got = trl.rl_deblur(torch.from_numpy(imgs), 1.0, 3).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    for i in range(3):
        single = trl.rl_deblur(torch.from_numpy(imgs[i]), 1.0, 3).numpy()
        np.testing.assert_array_equal(got[i], single)


@pytest.mark.parametrize("sigma", [1.0, 2.0, 3.0])
def test_rl_iter_reference_is_one_xla_iteration(sigma):
    img = _img((50, 70, 3), 4)
    ref = np.asarray(jrl.rl_deblur(jnp.asarray(img), sigma, 1, impl="xla"))
    d = torch.from_numpy(img).permute(2, 0, 1).contiguous()
    got = rl_fused.rl_iter_reference(d, d, trl.gaussian_taps_np(sigma))
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), ref,
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.5])
def test_taps_equal_jax(sigma):
    assert trl.psf_radius(sigma) == jrl.psf_radius(sigma)
    np.testing.assert_array_equal(trl.gaussian_taps_np(sigma),
                                  jrl.gaussian_taps_np(sigma))


def test_rl_to_u8_matches_jax_within_one_lsb():
    # straddle 0 and 1 so the clip and the quantize's cut both engage
    img = np.random.default_rng(5).random((64, 80, 3), dtype=np.float32) * 1.2 - 0.1
    ref = np.asarray(jrl.rl_to_u8_device(jnp.asarray(img), 1.0, 3, impl="xla"))
    got = trl.rl_to_u8_device(torch.from_numpy(img), 1.0, 3).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    u = np.random.default_rng(6).random((32, 32, 3), dtype=np.float32) * 1.1
    q_ref = np.asarray(jrl.gmic_quantize_u8(jnp.asarray(u)))
    q = trl.gmic_quantize_u8(torch.from_numpy(u)).numpy()
    assert np.abs(q.astype(int) - q_ref.astype(int)).max() <= 1


def test_rl_deblur_to_uint8_on_cpu():
    img = _img((40, 48, 3), 7)
    ref = jrl.rl_deblur_to_uint8(img, 1.0, 2, impl="xla")
    got = trl.rl_deblur_to_uint8(img, 1.0, 2, device="cpu")
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_unported_variants_raise():
    """Only an unknown PSF raises; gmic_fast and dt != 1 run (held against
    the JAX package in tests/test_torch_deriche.py)."""
    x = torch.ones(8, 8, 3)
    with pytest.raises(ValueError):
        trl.rl_deblur(x, psf="box")
    for kw in (dict(psf="gmic_fast"), dict(dt=0.5)):
        assert torch.isfinite(trl.rl_deblur(x, iterations=2, **kw)).all()
