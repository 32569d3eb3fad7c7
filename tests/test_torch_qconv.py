"""The port's int8 convolution pieces (``ops/qconv.py``, kernel P1's plain
version) against the JAX package on the CPU: the weight and activation
quantizers bit for bit, the calibration batches, the int32 convolution
exactly (VALID, FULL, explicit pads, lhs dilation 2), the dequantized
outputs, the parity-scaled epilogue, and quantize-then-pool."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from nind_denoise_tpu.ops import conv as JC
from nind_denoise_tpu.ops import qconv as JQ
from nind_denoise_tpu_torch.models.utnet_int8 import _pool
from nind_denoise_tpu_torch.ops import qconv as Q


def _rng(seed):
    return np.random.default_rng(seed)


def test_quant_kernel_bit_equal():
    w = (_rng(0).standard_normal((3, 3, 16, 8))
         * _rng(1).lognormal(0, 2, (1, 1, 1, 8))).astype(np.float32)
    jw, js = JQ.quant_kernel(jnp.asarray(w))
    tw, ts = Q.quant_kernel(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and tuple(ts.shape) == (8,)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_act_bit_equal_per_sample():
    x = _rng(2).standard_normal((3, 8, 9, 4)).astype(np.float32)
    x[2] = 0.0  # the 1e-12 floor: codes 0, no NaN
    jq, js = JQ.quant_act(jnp.asarray(x))
    tq, ts = Q.quant_act(torch.from_numpy(x))
    assert tuple(ts.shape) == (3, 1, 1, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq[2] == 0).all()


def test_quant_act_static_bit_equal_and_saturates():
    x = _rng(3).standard_normal((2, 8, 10, 5)).astype(np.float32)
    s = np.float32(0.004)  # |x| up to ~3: saturates often
    jq, _ = JQ.quant_act_static(jnp.asarray(x), jnp.asarray(s))
    tq, _ = Q.quant_act_static(torch.from_numpy(x), torch.tensor(s))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.abs().max() == 127


def test_quantize_before_pool_commutes_exactly():
    x = torch.from_numpy(_rng(4).standard_normal((2, 8, 10, 5)).astype(np.float32))
    s = torch.tensor(0.004)
    a = _pool(Q.quant_act_static(x, s)[0])
    b = Q.quant_act_static(_pool(x), s)[0]
    assert torch.equal(a, b)
    ref = np.asarray(JC.maxpool2x(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(_pool(x).numpy(), ref)


def test_calib_tiles_equal():
    np.testing.assert_array_equal(Q.calib_tiles(), np.asarray(JQ.calib_tiles()))
    np.testing.assert_array_equal(Q.calib_tiles(64, seed=3),
                                  np.asarray(JQ.calib_tiles(64, seed=3)))


@pytest.mark.parametrize("shape,scale", [((300, 400, 3), 1.0), ((40, 50, 3), 1.0),
                                         ((150, 210, 3), 65535.0)])
def test_calib_from_image_equal(shape, scale):
    img = _rng(5).random(shape, dtype=np.float32)
    if scale != 1.0:
        img = (img * scale).astype(np.uint16)
    np.testing.assert_array_equal(Q.calib_from_image(img, scale=scale),
                                  np.asarray(JQ.calib_from_image(img, scale=scale)))


def test_calib_from_image_finds_an_isolated_highlight():
    img = np.full((2003, 3001, 3), 0.1, np.float32)
    img[1231, 2741] = 1.0  # one pixel, prime coordinates
    got = Q.calib_from_image(img)
    np.testing.assert_array_equal(got, np.asarray(JQ.calib_from_image(img)))
    assert got.max() == 1.0


def _jax_i32(xq, wq_hwio, padding, dil):
    if padding == "FULL":
        kh, kw = wq_hwio.shape[:2]
        padding = ((kh - 1, kh - 1), (kw - 1, kw - 1))
    dn = lax.conv_dimension_numbers(xq.shape, wq_hwio.shape, ("NHWC", "HWIO", "NHWC"))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq_hwio), (1, 1), padding,
        lhs_dilation=None if dil == 1 else (dil, dil), dimension_numbers=dn,
        preferred_element_type=jnp.int32))


# (input NHWC, kernel, padding, lhs dilation)
CONV_CASES = [
    ((2, 9, 11, 16), 3, "VALID", 1),
    ((1, 7, 9, 8), 3, "FULL", 1),
    ((2, 8, 7, 24), 3, ((1, 2), (0, 3)), 1),
    ((1, 7, 9, 8), 4, ((3, 3), (3, 3)), 2),
    ((2, 5, 6, 12), 4, "FULL", 2),
]


@pytest.mark.parametrize("shape,k,padding,dil", CONV_CASES)
def test_int32_conv_exactly_equals_jax(shape, k, padding, dil):
    """The int32 sums of the plain version (and of ``qconv_raw``'s
    integer part) equal JAX's int32 convolution exactly: integer sums do
    not depend on the order."""
    g = _rng(6)
    xq = g.integers(-127, 128, shape).astype(np.int8)
    wq = g.integers(-127, 128, (k, k, shape[3], 10)).astype(np.int8)
    ref = _jax_i32(xq, wq, padding, dil)
    pads = Q.pads_of(padding, k, k)
    before = Q.launches
    got = Q.conv_int8(torch.from_numpy(xq), torch.from_numpy(wq).permute(3, 0, 1, 2),
                      pads, dil, out_dtype=torch.int32)
    assert Q.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("shape,k,padding,dil", CONV_CASES)
def test_qconv_raw_and_qconv_match_jax(shape, k, padding, dil, static):
    """``qconv_raw`` (fp32, no bias) and ``qconv`` (bias, cast) against
    JAX's, dynamic and static scales: the same int32 sums and the same fp32
    product order, so within one fp32 ulp (1e-6 relative)."""
    g = _rng(7)
    x = g.standard_normal(shape).astype(np.float32)
    w = g.standard_normal((k, k, shape[3], 10)).astype(np.float32)
    b = g.standard_normal(10).astype(np.float32)
    jwq, jsw = JQ.quant_kernel(jnp.asarray(w))
    twq, tsw = Q.quant_kernel(torch.from_numpy(w))
    lhs = None if dil == 1 else (dil, dil)
    sx = np.float32(0.01) if static else None
    ref = np.asarray(JQ.qconv_raw(jnp.asarray(x), jwq, jsw, padding, lhs_dilation=lhs,
                                  sx=None if sx is None else jnp.asarray(sx)))
    got = Q.qconv_raw(torch.from_numpy(x), twq, tsw, padding, lhs_dilation=lhs,
                      sx=None if sx is None else torch.tensor(sx)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    ref = np.asarray(JQ.qconv(jnp.asarray(x), jwq, jsw, jnp.asarray(b), padding,
                              lhs_dilation=lhs))
    got = Q.qconv(torch.from_numpy(x), twq, tsw, torch.from_numpy(b), padding,
                  lhs_dilation=lhs).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_int8_input_carries_its_scale():
    g = _rng(8)
    x = g.standard_normal((1, 6, 6, 8)).astype(np.float32)
    w = g.standard_normal((3, 3, 8, 4)).astype(np.float32)
    wq, sw = Q.quant_kernel(torch.from_numpy(w))
    xq, sx = Q.quant_act_static(torch.from_numpy(x), torch.tensor(0.02))
    a = Q.qconv(xq, wq, sw, padding="VALID", sx=sx, out_dtype=torch.float32)
    b = Q.qconv(torch.from_numpy(x), wq, sw, padding="VALID", sx=sx)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        Q.qconv(xq, wq, sw, padding="VALID", sx=sx)  # no out_dtype
    with pytest.raises(ValueError):
        Q.qconv_raw(xq, wq, sw, "VALID")  # no scale


def test_parity_scales_pick_by_output_column():
    """Two scale vectors (2, cout): output column x takes row x % 2, as
    P1's epilogue does for the level-4 composed conv."""
    g = _rng(9)
    xq = torch.from_numpy(g.integers(-127, 128, (2, 5, 6, 8)).astype(np.int8))
    wk = torch.from_numpy(g.integers(-127, 128, (6, 4, 4, 8)).astype(np.int8))
    sx = torch.tensor([0.5, 0.25])
    sw = torch.from_numpy(g.random((2, 6)).astype(np.float32))
    bias = torch.from_numpy(g.random(6).astype(np.float32))
    pads = (3, 3, 3, 3)
    acc = Q.conv_int8(xq, wk, pads, 2, out_dtype=torch.int32)
    y = Q.conv_int8(xq, wk, pads, 2, sx=sx, sw=sw, bias=bias, out_dtype=torch.bfloat16)
    for col in range(acc.shape[2]):
        want = (acc[:, :, col].float() * (sx[:, None, None] * sw[col % 2])
                + bias).to(torch.bfloat16)
        assert torch.equal(y[:, :, col], want), col


def test_conv_int8_rejects_what_it_does_not_take():
    xq = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    wk = torch.zeros((4, 3, 3, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        Q.conv_int8(xq.float(), wk, (0, 0, 0, 0))
    with pytest.raises(ValueError):
        Q.conv_int8(xq, wk, (0, 0, 0, 0), dil=3)
    with pytest.raises(ValueError):
        Q.conv_int8(xq, wk, (0, 0, 0, 0), out_dtype=torch.float32)  # no scales
    with pytest.raises(ValueError):
        Q.conv_int8(xq, wk[:, :, :, :4], (0, 0, 0, 0))
