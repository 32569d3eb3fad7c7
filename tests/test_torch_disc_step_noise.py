"""The measures that chip_smoke's gan phase holds the card's fp32
discriminator step with (``tools/disc_step_noise.py``), on the CPU.

An fp32 convolution stays under its rounding bound at every stride and
dilation of the Hul plan, and one whose operands were rounded to bf16 or
TF32 reads above it; ``op_as`` runs one op class in float64 (running
stats written back) and restores it; BatchNorm by its formula is torch's;
distances pool over batches as over one concatenated step.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nind_denoise_tpu_torch.tools import disc_step_noise as dsn


def _operands(seed, cin=12, cout=8, hw=23, bias=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, cin, hw, hw)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(cout, cin, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=cout).astype(np.float32)) if bias else None
    return x, w, b


def _tf32(t):
    """``t`` with its mantissa cut to TF32's 10 bits (round to nearest)."""
    i = t.view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("stride,dilation,bias", [(1, 1, True), (1, 2, False), (3, 1, False),
                                                  (1, 5, False)])
def test_fp32_conv_stays_under_its_rounding_bound(stride, dilation, bias):
    x, w, b = _operands(stride * 10 + dilation, bias=bias)
    x.requires_grad_()
    bound = {"forward": 0.0}
    with dsn.bounding_convs(bound):
        y = F.conv2d(x, w, b, stride, 0, dilation)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    assert set(bound) == {"forward", "input_grad", "weight_grad"}
    assert all(0 < v < 1 for v in bound.values()), bound


@pytest.mark.parametrize("rounding", ["bf16", "tf32"])
def test_reduced_precision_operands_break_the_bound(rounding):
    x, w, b = _operands(3)
    cut = (lambda t: t.bfloat16().float()) if rounding == "bf16" else _tf32
    y = F.conv2d(cut(x), cut(w), b)
    assert dsn.conv_error_over_bound([(x, w, b, 1, 0, 1, 1, y)])["forward"] > 3


def test_op_as_widens_one_op_and_restores_it():
    x, w, b = _operands(4)
    keep = F.conv2d
    with dsn.op_as("conv2d"):
        y = F.conv2d(x, w, b)
    assert F.conv2d is keep
    assert y.dtype == torch.float32
    assert torch.equal(y, F.conv2d(x.double(), w.double(), b.double()).float())

    rm, rv = torch.zeros(12), torch.ones(12)
    rm64, rv64 = rm.double(), rv.double()
    with dsn.op_as("batch_norm"):
        F.batch_norm(x, rm, rv, None, None, True, 0.1, 1e-5)
    F.batch_norm(x.double(), rm64, rv64, None, None, True, 0.1, 1e-5)
    assert torch.equal(rm, rm64.float()) and torch.equal(rv, rv64.float())


def test_batch_norm_formula_is_torchs():
    x, _, _ = _operands(5)
    w, b = torch.rand(12) + 0.5, torch.randn(12)
    rm, rv, rm2, rv2 = torch.zeros(12), torch.ones(12), torch.zeros(12), torch.ones(12)
    y = dsn._bn_formula(x, rm, rv, w, b, True, 0.1, 1e-5)
    ref = F.batch_norm(x, rm2, rv2, w, b, True, 0.1, 1e-5)
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rm, rm2, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(rv, rv2, atol=1e-6, rtol=1e-6)


def test_distances_pool_as_one_step():
    rng = np.random.default_rng(6)

    def step(n):
        ts = [torch.from_numpy(rng.normal(size=s)) for s in ((n, 3), (4,))]
        return ts, [t * 0.1 for t in ts], [0.5, 0.25]

    a, b, ra, rb = step(5), step(7), step(5), step(7)
    pooled = dsn.measures([dsn.spread(a, ra), dsn.spread(b, rb)])
    one = dsn.measures([dsn.spread((a[0] + b[0], a[1] + b[1], a[2]),
                                   (ra[0] + rb[0], ra[1] + rb[1], ra[2]))])
    for k in ("grad_rel", "param_rms_over_lr", "param_max_over_lr", "param_share_over_lr_1pct"):
        assert pooled[k] == pytest.approx(one[k], rel=1e-12)


def test_planted_tf32_is_undone():
    from nind_denoise_tpu_torch.train import steps

    keep = steps._tf32
    with dsn.planted_tf32():
        assert steps._tf32 is not keep
    with dsn.planted_tf32(False):
        assert steps._tf32 is keep
    assert steps._tf32 is keep
