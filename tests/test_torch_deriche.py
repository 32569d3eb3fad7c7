"""The port's Deriche IIR (kernel P2's plain version, ``ops/deriche.py``)
and RL's ``psf='gmic_fast'`` and ``dt != 1`` against the JAX package on the
CPU: the coefficients, one axis pass along H and W against ``_deriche_axis``
over sigma from the 0.1 clamp to 10, ``rl_deblur`` against
``rl_deblur(impl='xla')``, the uint8 path, and the route each (R, psf, dt)
takes before any launch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nind_denoise_tpu.ops import rl_deblur as jrl
from nind_denoise_tpu_torch.ops import deriche, gauss_blur, rl_deblur as trl, rl_fused

SIGMAS = [0.05, 0.7, 1.0, 3.0, 10.0]  # 0.05: below the 0.1 clamp


def _img(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32) + 0.05


@pytest.mark.parametrize("sigma", SIGMAS)
def test_coefficients_equal_jax_as_fp32(sigma):
    ref = jrl._deriche_coeffs(sigma)
    got = deriche.coeffs(sigma)
    assert set(got) == set(ref) == set(deriche.KEYS)
    for k in deriche.KEYS:
        assert got[k] == float(np.float32(ref[k])), k


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_axis_pass_matches_jax_scan(sigma, axis):
    """One pass along H (axis 1) or W (axis 2) of (P, H, W) planes against
    the JAX scans on the same NHWC image; fp32, the same operation order,
    limit 2e-6 x max(1, |ref|) for the compiler's freedom on the JAX side."""
    img = _img((1, 37, 45, 3), 1)
    ref = np.asarray(jrl._deriche_axis(jnp.asarray(img), sigma, axis))
    planes = torch.from_numpy(img).permute(0, 3, 1, 2).reshape(3, 37, 45)
    before = deriche.launches
    got = deriche.deriche_axis(planes, sigma, axis).reshape(1, 3, 37, 45) \
        .permute(0, 2, 3, 1).numpy()
    assert deriche.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-6 * max(1.0, float(np.abs(ref).max())))


def test_blur_is_h_then_w_and_rejects_other_axes():
    img = _img((2, 20, 30), 2)
    x = torch.from_numpy(img)
    want = deriche.deriche_axis_reference(deriche.deriche_axis_reference(x, 2.0, 1), 2.0, 2)
    assert torch.equal(deriche.deriche_blur(x, 2.0), want)
    with pytest.raises(ValueError):
        deriche.deriche_axis(x, 2.0, 0)


# (psf, sigma, dt): the Deriche route at dt 1 and 0.5, the K3 route at dt
# 0.5 and 1.5, and sigma 0 on the Deriche route (the clamp: no NaN)
RL_CASES = [("gmic_fast", 1.0, 1.0), ("gmic_fast", 3.0, 0.5), ("gaussian", 1.0, 0.5),
            ("gaussian", 2.0, 1.5), ("gmic_fast", 0.0, 1.0)]


@pytest.mark.parametrize("psf,sigma,dt", RL_CASES)
def test_rl_deblur_matches_xla(psf, sigma, dt):
    """10 iterations against the JAX XLA path; limit 2e-5 relative (the
    blurs' last bits compound over the iterations)."""
    img = _img((46, 58, 3), 3)
    ref = np.asarray(jrl.rl_deblur(jnp.asarray(img), sigma, 10, dt, impl="xla", psf=psf))
    before = dict(trl.routes)
    got = trl.rl_deblur(torch.from_numpy(img), sigma, 10, dt, psf=psf).numpy()
    route = trl.route_for(trl.psf_radius(sigma), psf, dt)
    assert {k: trl.routes[k] - before[k] for k in trl.ROUTES} == {
        k: int(k == route) for k in trl.ROUTES}
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5 * float(np.abs(ref).max()))


def test_rl_deblur_to_uint8_within_one_lsb():
    img = _img((40, 52, 3), 4) * 0.9
    for psf, dt in (("gmic_fast", 1.0), ("gaussian", 0.5)):
        ref = jrl.rl_deblur_to_uint8(img, 1.0, 10, dt, impl="xla", psf=psf)
        got = trl.rl_deblur_to_uint8(img, 1.0, 10, dt, device="cpu", psf=psf)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, (psf, dt)


@pytest.mark.parametrize("radius,psf,dt,route", [
    (3, "gaussian", 1.0, "fused"), (32, "gaussian", 1.0, "fused"),
    (3, "gaussian", 0.5, "separable_k3"), (32, "gaussian", 1.5, "separable_k3"),
    (64, "gaussian", 0.5, "separable_k3"), (65, "gaussian", 0.5, "separable_plain"),
    (3, "gmic_fast", 1.0, "deriche"), (66, "gmic_fast", 0.5, "deriche")])
def test_route_for_psf_and_dt(radius, psf, dt, route):
    assert trl.route_for(radius, psf, dt) == route


def test_routes_launch_nothing_on_the_cpu():
    """The route is picked from (R, psf, dt) before any launch; on the CPU
    every route runs plain versions, so no kernel counts a launch."""
    img = torch.from_numpy(_img((24, 30, 3), 5))
    counts = lambda: (rl_fused.launches, gauss_blur.launches, deriche.launches)
    before = counts()
    for psf, dt in (("gmic_fast", 1.0), ("gaussian", 0.5)):
        trl.rl_deblur(img, 1.0, 2, dt, psf=psf)
    assert counts() == before


def test_denoise_cli_gmic_fast_matches_jax(tmp_path, monkeypatch):
    """``denoise --tiff-input --rl-psf gmic_fast`` on both sides at
    ``--compute_dtype float32`` (as the other CLI tests run): the
    pre-encode uint8 within 1 LSB."""
    import cv2

    from nind_denoise_tpu.pipeline import denoise_cli as jax_cli
    from nind_denoise_tpu.pipeline import denoise_image_cli as jax_image_cli
    from nind_denoise_tpu_torch.pipeline import denoise_cli as port_cli
    from nind_denoise_tpu_torch.tools import fixtures

    ckpt = str(tmp_path / "generator_1.npz")
    fixtures.write_jax_checkpoint(ckpt, 8, seed=21)
    tif = str(tmp_path / "img.tif")
    img = (np.random.default_rng(2).random((120, 140, 3)) * 65535).astype(np.uint16)
    assert cv2.imwrite(tif, img)
    monkeypatch.setattr(jax_image_cli, "_resolve_devices", lambda args: 1)
    seen = {}
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        def spy(u8, path, quality, _side=side, _encode=cli._encode_u8):
            seen[_side] = np.array(u8)
            _encode(u8, path, quality)

        monkeypatch.setattr(cli, "_encode_u8", spy)
        out = tmp_path / side
        out.mkdir()
        before = dict(trl.routes)
        cli.main([tif, "--tiff-input", "--model_path", ckpt, "-o", str(out), "--cs", "104",
                  "--ucs", "88", "--batch_size", "2", "--compute_dtype", "float32",
                  "--rl-psf", "gmic_fast", "--sigma", "2"]
                 + (["--device", "cpu"] if side == "port" else []))
        assert (out / "img.jpg").is_file()
        if side == "port":
            assert trl.routes["deriche"] == before["deriche"] + 1
    assert seen["port"].shape == seen["jax"].shape == (120, 140, 3)
    assert np.abs(seen["port"].astype(int) - seen["jax"].astype(int)).max() <= 1
