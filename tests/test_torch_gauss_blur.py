"""The port's Gaussian blur (K3's plain version on the CPU) against the
JAX package: ``gauss_blur_pallas`` in interpret mode and the lax blur
``rl_deblur._blur``, plus the radius limit and the canonical taps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nind_denoise_tpu.ops import pallas_blur
from nind_denoise_tpu.ops import rl_deblur as jrl
from nind_denoise_tpu_torch.ops import gauss_blur as tgb
from nind_denoise_tpu_torch.ops import rl_deblur as trl

ATOL = 2e-6  # fp32, tests/test_pallas_blur.py's bar


def _img(hw, seed):
    return np.random.default_rng(seed).random((*hw, 3), dtype=np.float32)


@pytest.mark.parametrize("hw,sigma", [((64, 96), 1.0), ((50, 70), 2.0)])
def test_gauss_blur_matches_pallas_interpret(hw, sigma):
    img = _img(hw, 0)
    ref = np.asarray(pallas_blur.gauss_blur_pallas(jnp.asarray(img), sigma=sigma,
                                                   band_h=16, interpret=True))
    got = tgb.gauss_blur(torch.from_numpy(img), sigma)
    assert got.shape == img.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("hw", [(97, 131), (5, 7)])  # odd sizes; smaller than r = 9
def test_gauss_blur_matches_lax_blur(hw):
    img = _img(hw, 1)
    ref = np.asarray(jrl._blur(jnp.asarray(img)[None], jrl.gaussian_psf_1d(3.0)))[0]
    got = tgb.gauss_blur(torch.from_numpy(img), 3.0).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_gauss_blur_radius_limit():
    img = torch.from_numpy(_img((8, 8), 2))
    assert tgb.gauss_blur(img, 21.0).shape == img.shape  # r = 63
    with pytest.raises(ValueError, match="radius 66"):
        tgb.gauss_blur(img, 22.0)


@pytest.mark.parametrize("sigma", [1.0, 3.0, 21.0])
def test_gauss_taps_equal_jax(sigma):
    np.testing.assert_array_equal(trl.gaussian_taps_np(sigma),
                                  jrl.gaussian_taps_np(sigma))


# K3's geometry changes at these radii (csrc/gauss_blur.cu): 64-wide tiles
# to R 16, 128-wide above; two CTAs an SM to R 38, one above; RL's routes
# part at R 32/33; R 64 is the last instance. The shapes are ragged,
# smaller than a tile, and most of them smaller than R in one dimension.
SWITCHES = [(8, (7, 61)), (9, (5, 63)), (16, (15, 30)), (17, (11, 70)),
            (32, (31, 45)), (33, (20, 129)), (38, (9, 50)), (39, (37, 21)),
            (63, (40, 62)), (64, (63, 131))]


def _sigma(radius):
    return (radius - 0.5) / 3  # ceil(3 sigma) = radius


@pytest.mark.parametrize("radius,hw", SWITCHES[:6])  # the lax blur is slow to build above
def test_gauss_blur_matches_lax_blur_at_tile_switches(radius, hw):
    sigma = _sigma(radius)
    assert jrl.psf_radius(sigma) == radius
    img = _img(hw, radius)
    ref = np.asarray(jrl._blur(jnp.asarray(img)[None], jrl.gaussian_psf_1d(sigma)))[0]
    got = tgb.gauss_blur(torch.from_numpy(img), sigma).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("radius,hw", SWITCHES)
def test_gauss_blur_matches_pallas_interpret_at_tile_switches(radius, hw):
    sigma = _sigma(radius)
    img = _img(hw, radius + 100)
    ref = np.asarray(pallas_blur.gauss_blur_pallas(jnp.asarray(img), sigma=sigma,
                                                   band_h=16, interpret=True))
    got = tgb.gauss_blur(torch.from_numpy(img), sigma).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_device_taps_are_copied_once_per_sigma():
    first = tgb._device_taps(1.0, torch.device("cpu"))
    assert tgb._device_taps(1.0, torch.device("cpu")) is first
    np.testing.assert_array_equal(first.numpy(), trl.gaussian_taps_np(1.0))
