"""The port's RL route, chosen from the PSF radius before any launch,
against the JAX package on the CPU: ``route_for`` at the limits of K1
(R 32) and K3 (R 64), ``psf_radius`` where sigma crosses them, each route's
``rl_deblur`` against ``rl_deblur(impl='xla')``, K3's planar entry
``blur_planes`` against its HWC plain version and, at the radii where
K3's geometry changes, against the JAX package's blurs, the route counter,
and the breakdown tools' source handling."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nind_denoise_tpu.ops import pallas_blur
from nind_denoise_tpu.ops import rl_deblur as jrl
from nind_denoise_tpu_torch.ops import gauss_blur as tgb
from nind_denoise_tpu_torch.ops import rl_deblur as trl
from nind_denoise_tpu_torch.ops import rl_fused

ATOL = RTOL = 2e-5  # tests/test_torch_rl_deblur.py's bar


def _img(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32) + 0.05


@pytest.mark.parametrize("radius,route", [
    (1, "fused"), (30, "fused"), (32, "fused"),
    (33, "separable_k3"), (64, "separable_k3"), (65, "separable_plain")])
def test_route_for(radius, route):
    assert trl.route_for(radius) == route


@pytest.mark.parametrize("sigma,radius", [(10.0, 30), (10.7, 33), (22.0, 66)])
def test_psf_radius(sigma, radius):
    assert trl.psf_radius(sigma) == jrl.psf_radius(sigma) == radius


# sigma 6 (R 18) and 11 (R 33) on K1 and K3, 22 (R 66) on the plain blur;
# R 66 is wider than the image, so the edge replicate covers whole rows
@pytest.mark.parametrize("sigma,route", [
    (6.0, "fused"), (11.0, "separable_k3"), (22.0, "separable_plain")])
def test_rl_deblur_routes_match_xla(sigma, route):
    img = _img((70, 90, 3), 11)
    ref = np.asarray(jrl.rl_deblur(jnp.asarray(img), sigma, 2, impl="xla"))
    before = dict(trl.routes)
    got = trl.rl_deblur(torch.from_numpy(img), sigma, 2).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert {k: trl.routes[k] - before[k] for k in trl.ROUTES} == {
        k: int(k == route) for k in trl.ROUTES}


@pytest.mark.parametrize("sigma", [6.0, 11.0, 22.0])
def test_routes_equal_the_fused_iteration_bit_for_bit(sigma):
    imgs = _img((2, 40, 50, 3), 12)
    got = trl.rl_deblur(torch.from_numpy(imgs), sigma, 3)
    d = torch.from_numpy(imgs).permute(0, 3, 1, 2).reshape(6, 40, 50)
    taps = trl.gaussian_taps_np(sigma)
    u = d
    for _ in range(3):
        u = rl_fused.rl_iter_reference(u, d, taps)
    assert torch.equal(got, u.reshape(2, 3, 40, 50).permute(0, 2, 3, 1))


@pytest.mark.parametrize("sigma,hw", [(1.0, (37, 53)), (11.0, (40, 30)), (21.0, (9, 70))])
def test_blur_planes_equals_gauss_blur_reference_per_plane(sigma, hw):
    x = torch.from_numpy(_img((4, *hw), 13))
    taps = torch.from_numpy(trl.gaussian_taps_np(sigma))
    launches = tgb.launches
    got = tgb.blur_planes(x, taps)
    assert tgb.launches == launches  # the plain version launches nothing
    assert got.shape == x.shape
    for p in range(4):
        ref = tgb.gauss_blur_reference(x[p][..., None], sigma)[..., 0]
        assert torch.equal(got[p], ref)


def test_blur_planes_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="taps"):
        tgb.blur_planes(x, torch.from_numpy(trl.gaussian_taps_np(22.0)))  # R 66
    with pytest.raises(ValueError, match="taps"):
        tgb.blur_planes(x, torch.ones(4))


def test_route_counter_advances_once_per_call():
    x = torch.from_numpy(_img((12, 16, 3), 14))
    before = dict(trl.routes)
    for sigma in (1.0, 10.0, 10.7, 21.3, 21.4):
        trl.rl_deblur(x, sigma, 1)
    trl.rl_to_u8_device(x, 11.0, 1)
    assert {k: trl.routes[k] - before[k] for k in trl.ROUTES} == {
        "fused": 2, "separable_k3": 3, "separable_plain": 1}


def test_rl_iter_breakdown_variants_apply_to_the_kernel():
    # rl_iter_breakdown's source substitutions must keep matching csrc/rl_iter.cu
    from nind_denoise_tpu_torch.ops import _build
    from nind_denoise_tpu_torch.tools import rl_iter_breakdown as B

    src = (_build.CSRC / "rl_iter.cu").read_text()
    for name, subs in B.VARIANTS.items():
        out = B.variant_source(src, subs)
        assert (out == src) == (name == "shipped")
    with pytest.raises(RuntimeError, match="no longer has"):
        B.variant_source(src, B.PARENT["parent"])


# the radii where K3's geometry changes (tests/test_torch_gauss_blur.py),
# on ragged planes smaller than a tile and, in one dimension, than R
PLANE_SWITCHES = [(8, (2, 61, 7)), (9, (3, 5, 40)), (16, (2, 30, 15)), (17, (1, 70, 11)),
                  (32, (2, 45, 31)), (33, (3, 40, 129)), (38, (2, 50, 9)),
                  (39, (1, 21, 37)), (63, (2, 62, 40)), (64, (2, 131, 63))]


@pytest.mark.parametrize("radius,shape", PLANE_SWITCHES[:6])  # the lax blur is slow to build above
def test_blur_planes_matches_lax_blur_at_tile_switches(radius, shape):
    sigma = (radius - 0.5) / 3
    x = _img(shape, radius)
    taps = trl.gaussian_taps_np(sigma)
    ref = np.asarray(jrl._blur(jnp.asarray(x.transpose(1, 2, 0))[None],
                               jrl.gaussian_psf_1d(sigma)))[0].transpose(2, 0, 1)
    got = tgb.blur_planes(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)  # tests/test_pallas_blur.py's bar


@pytest.mark.parametrize("radius,shape", PLANE_SWITCHES)
def test_blur_planes_matches_pallas_interpret_at_tile_switches(radius, shape):
    sigma = (radius - 0.5) / 3
    x = _img(shape, radius + 50)
    taps = trl.gaussian_taps_np(sigma)
    assert len(taps) == 2 * radius + 1
    ref = np.asarray(pallas_blur.gauss_blur_pallas(jnp.asarray(x.transpose(1, 2, 0)),
                                                   sigma=sigma, band_h=16, interpret=True))
    got = tgb.blur_planes(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    np.testing.assert_allclose(got, ref.transpose(2, 0, 1), atol=2e-6)


def test_gauss_blur_breakdown_sources_apply_to_the_kernel():
    # gauss_blur_breakdown's substitutions must keep matching csrc/gauss_blur.cu,
    # and a parent source must have the C entries the wrappers call
    from nind_denoise_tpu_torch.ops import _build
    from nind_denoise_tpu_torch.tools import gauss_blur_breakdown as B

    src = (_build.CSRC / "gauss_blur.cu").read_text()
    for name, subs in B.VARIANTS.items():
        out = B.variant_source(src, subs)
        assert (out == src) == (name == "shipped")
    assert B.parent_source(src) == src
    with pytest.raises(RuntimeError, match="lacks"):
        B.parent_source(src.replace("int gauss_blur_planes_launch(", "int blur_planes("))
    assert set(B.REGISTER_RADII) <= set(range(1, 65))
