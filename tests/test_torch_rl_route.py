"""The port's RL route, chosen from the PSF radius before any launch,
against the JAX package on the CPU: ``route_for`` at the limits of K1
(R 32) and K3 (R 64), ``psf_radius`` where sigma crosses them, each route's
``rl_deblur`` against ``rl_deblur(impl='xla')``, K3's planar entry
``blur_planes`` against its HWC plain version and, at the radii where
K3's geometry changes, against the JAX package's blurs, the route counter,
the breakdown tools' source handling, and ``--rl-impl`` (the JAX CLI's
``auto|xla|pallas``) mapped onto the routes, with ``pallas`` refused where
the fused kernel cannot run."""

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
        "fused": 2, "separable_k3": 3, "separable_plain": 1, "deriche": 0}


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


# --rl-impl: the JAX CLI's choices mapped onto the port's routes
@pytest.mark.parametrize("impl,radius,psf,dt,route", [
    ("auto", 3, "gaussian", 1.0, "fused"), ("auto", 3, "gaussian", 0.5, "separable_k3"),
    ("xla", 3, "gaussian", 1.0, "separable_k3"), ("xla", 32, "gaussian", 1.0, "separable_k3"),
    ("xla", 65, "gaussian", 1.0, "separable_plain"), ("xla", 3, "gmic_fast", 1.0, "deriche"),
    ("pallas", 3, "gaussian", 1.0, "fused"), ("pallas", 32, "gaussian", 1.0, "fused")])
def test_route_for_impl(impl, radius, psf, dt, route):
    assert trl.route_for(radius, psf, dt, impl) == route


@pytest.mark.parametrize("radius,psf,dt", [
    (3, "gaussian", 0.5), (3, "gmic_fast", 1.0), (33, "gaussian", 1.0)])
def test_route_for_pallas_refuses_what_k1_cannot_run(radius, psf, dt):
    with pytest.raises(NotImplementedError, match="fused RL kernel"):
        trl.route_for(radius, psf, dt, "pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        trl.route_for(radius, psf, dt, "triton")


def test_rl_impl_xla_equals_the_jax_xla_path():
    """``impl='xla'`` at sigma 1 takes the separable body, not K1, and agrees
    with the JAX package's xla path."""
    img = _img((21, 26, 3), 41)
    before = dict(trl.routes)
    got = trl.rl_deblur(torch.from_numpy(img), 1.0, 5, impl="xla").numpy()
    assert trl.routes["separable_k3"] == before["separable_k3"] + 1
    assert trl.routes["fused"] == before["fused"]
    ref = np.asarray(jrl.rl_deblur(jnp.asarray(img), 1.0, 5, impl="xla"))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("flags,routed", [
    ([], "fused"), (["--rl-impl", "xla"], "separable_k3"), (["--rl-impl", "pallas"], "fused"),
    (["--rl-impl", "pallas", "--rl-psf", "gmic_fast"], NotImplementedError)])
def test_denoise_cli_rl_impl(tmp_path, flags, routed):
    """``denoise --rl-impl`` parses as in the JAX CLI and reaches the RL
    route; ``pallas`` where K1 cannot run raises."""
    import cv2

    from nind_denoise_tpu.pipeline import denoise_cli as jax_cli
    from nind_denoise_tpu_torch.pipeline import denoise_cli as port_cli
    from nind_denoise_tpu_torch.tools.fixtures import write_jax_checkpoint

    assert jax_cli.build_parser().parse_args(["x"] + flags).rl_impl == \
        port_cli.build_parser().parse_args(["x"] + flags).rl_impl
    ckpt = str(tmp_path / "generator_1.npz")
    write_jax_checkpoint(ckpt, 8, seed=4)
    tif = str(tmp_path / "img.tif")
    assert cv2.imwrite(tif, (np.random.default_rng(4).random((40, 52, 3)) * 65535)
                       .astype(np.uint16))
    (tmp_path / "out").mkdir()
    argv = [tif, "--tiff-input", "--model_path", ckpt, "-o", str(tmp_path / "out"),
            "--device", "cpu", "--cs", "104", "--ucs", "88", "--compute_dtype",
            "float32"] + flags
    before = dict(trl.routes)
    if routed is NotImplementedError:
        with pytest.raises(NotImplementedError, match="fused RL kernel"):
            port_cli.main(argv)
        return
    port_cli.main(argv)
    assert trl.routes[routed] == before[routed] + 1
