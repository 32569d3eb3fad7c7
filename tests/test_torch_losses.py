"""The port's image losses (``nind_denoise_tpu_torch/ops/losses.py``)
against the JAX package's, values and gradients, on seeded inputs.

Tolerances: float32 throughout. The windows' sums differ in order between
XLA and PyTorch, and at MS-SSIM's coarsest scale (11 px, one window) the
variance terms cancel, so MS-SSIM is held to 2e-5 absolute and its
gradient to 1e-6 absolute (its largest entry is about 2e-4); the SSIM loss
(1 - SSIM, so one float32 ulp of 1 is 6e-8) to 2e-7 absolute; MSE, L1 and
PSNR to 1e-6 relative; the gradients of all four to 1e-8 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from nind_denoise_tpu.ops import losses as JL
from nind_denoise_tpu.ops.conv import avgpool2x_ceil as jax_avgpool
from nind_denoise_tpu_torch.ops import losses as L
from nind_denoise_tpu_torch.ops.conv import avgpool2x_ceil


def _pair(shape, seed=0, sigma=0.1):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.clip(x + rng.normal(0, sigma, shape), 0, 1).astype(np.float32)
    return x, y


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("hw", [(8, 8), (9, 7), (165, 171)])
def test_avgpool2x_ceil_matches_jax(hw):
    x, _ = _pair((2, *hw, 3))
    got = avgpool2x_ceil(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_avgpool(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


# (name, value atol, value rtol, grad atol)
CASES = [("ssim_loss", 2e-7, 0, 1e-8), ("ms_ssim_loss", 2e-5, 0, 1e-6),
         ("mse_loss", 0, 1e-6, 1e-8), ("l1_loss", 0, 1e-6, 1e-8),
         ("psnr", 0, 1e-6, 1e-8)]


@pytest.mark.parametrize("name,atol,rtol,gatol", CASES)
def test_loss_and_gradient_match_jax(name, atol, rtol, gatol):
    x, y = _pair((2, 165, 171, 3))
    jv, jg = jax.jit(jax.value_and_grad(
        lambda a: getattr(JL, name)(a, jnp.asarray(y)).mean()))(jnp.asarray(x))
    tx = _nchw(x).requires_grad_()
    tv = getattr(L, name)(tx, _nchw(y)).mean()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=rtol, atol=atol)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg),
                               rtol=0, atol=gatol)
    assert np.abs(np.asarray(jg)).max() > 10 * gatol


def test_per_sample_shapes():
    x, y = _pair((3, 170, 162, 3), seed=1)
    for name in ("ssim", "ms_ssim", "ssim_loss", "ms_ssim_loss", "mse_loss",
                 "l1_loss", "psnr"):
        out = getattr(L, name)(_nchw(x), _nchw(y))
        assert out.shape == (3,) and torch.isfinite(out).all(), name
    ss, cs = L.ssim_per_channel(_nchw(x), _nchw(y))
    assert ss.shape == cs.shape == (3, 3)


def test_ms_ssim_needs_162_px():
    x, y = _pair((1, 161, 200, 3))
    with pytest.raises(ValueError, match="162"):
        L.ms_ssim(_nchw(x), _nchw(y))
    with pytest.raises(ValueError, match="162"):
        JL.ms_ssim(jnp.asarray(x), jnp.asarray(y))
    x, y = _pair((1, 162, 162, 3))
    assert torch.isfinite(L.ms_ssim(_nchw(x), _nchw(y))).all()


def test_ms_ssim_dead_zone_gives_zero_gradient_not_nan():
    """tests/test_msssim_warmup.py's dead zone: a conv whose output puts
    one scale's cs below 0 gets MS-SSIM loss 1 and exactly zero gradient
    in both packages, while MSE's gradient flows from the same point."""
    rng = np.random.default_rng(0)
    target = rng.random((1, 168, 168, 3), np.float32)
    noisy = np.clip(target + rng.normal(0, 0.1, target.shape).astype(np.float32), 0, 1)
    w = rng.normal(0, 0.1, (3, 3, 3, 3)).astype(np.float32)

    def jfwd(w):
        dn = lax.conv_dimension_numbers(noisy.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
        return lax.conv_general_dilated(jnp.asarray(noisy), w, (1, 1), "SAME",
                                        dimension_numbers=dn)

    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda w: JL.ms_ssim_loss(jfwd(w), jnp.asarray(target)).mean()))(jnp.asarray(w))
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    out = torch.nn.functional.conv2d(_nchw(noisy), tw, padding=1)
    loss = L.ms_ssim_loss(out, _nchw(target)).mean()
    loss.backward()
    assert float(jloss) == loss.item() == 1.0
    assert float(jnp.abs(jgrad).max()) == 0.0
    assert not torch.isnan(tw.grad).any() and tw.grad.abs().max().item() == 0.0
    tw.grad = None
    L.mse_loss(torch.nn.functional.conv2d(_nchw(noisy), tw, padding=1),
               _nchw(target)).mean().backward()
    assert tw.grad.abs().max().item() > 0


def test_gaussian_kernel_matches_jax():
    np.testing.assert_allclose(L.gaussian_kernel().numpy(),
                               np.asarray(JL.gaussian_kernel()), rtol=2e-7, atol=0)
    assert abs(L.gaussian_kernel().sum().item() - 1) < 1e-6
