"""The port's UtNet forward against the JAX UtNet on the CPU in fp32:
``UtNet.apply`` for every activation, ``UtNet.apply_fast`` with the Pallas
enc1 kernel in interpret mode, and the port's enc1 plain version against
the JAX level-1 activations."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nind_denoise_tpu.models.utnet import UtNet as JaxUtNet
from nind_denoise_tpu.ops import conv as JC
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.models.utnet import UtNet, check_cs
from nind_denoise_tpu_torch.ops import enc1 as enc1_op
from nind_denoise_tpu_torch.ops.conv import reflect_pad

# float32 on the CPU: both sides sum the same convs in different orders
ATOL, RTOL = 2e-5, 1e-4  # as tests/test_models_parity.py


def _pair(activation="PReLU", seed=0):
    params = JaxUtNet.init(jax.random.PRNGKey(seed), funit=8, activation=activation)
    model = UtNet(8, activation)
    model.load_state_dict(params_io.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return params, model.eval()


def _port(model, x_nhwc):
    with torch.no_grad():
        y = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("hw", [(104, 104), (104, 136)])
@pytest.mark.parametrize("activation", ["PReLU", "ELU", "Hardswish"])
def test_utnet_matches_jax_apply(activation, hw):
    params, model = _pair(activation, seed=1)
    x = np.random.default_rng(2).random((2, *hw, 3), dtype=np.float32)
    ref = np.asarray(JaxUtNet.apply(params, jnp.asarray(x), activation=activation))
    got = _port(model, x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_utnet_matches_jax_apply_fast_pallas_enc1():
    """The JAX product forward with the Pallas enc1 kernel (interpret mode
    on the CPU) against the port's forward through its enc1 op."""
    params, model = _pair(seed=3)
    x = np.random.default_rng(4).random((1, 104, 136, 3), dtype=np.float32)
    ref = np.asarray(JaxUtNet.apply_fast(params, jnp.asarray(x),
                                         enc1_impl="pallas"))
    np.testing.assert_allclose(_port(model, x), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw", [(40, 72), (56, 56)])
def test_enc1_reference_matches_jax_level1(hw):
    params, model = _pair(seed=5)
    x = np.random.default_rng(6).random((2, *hw, 3), dtype=np.float32)
    p = params["convs1"]
    act = lambda t, q: JC.apply_activation(t, "PReLU", q.get("a"))
    t = JC.reflect_pad(jnp.asarray(x), 2)
    t = act(JC.conv2d(t, p["c0"]["w"], p["c0"]["b"], "VALID"), p["c0"])
    l1_ref = np.asarray(act(JC.conv2d(t, p["c1"]["w"], p["c1"]["b"], "VALID"), p["c1"]))
    l2_ref = np.asarray(JC.maxpool2x(jnp.asarray(l1_ref)))
    c0, a0, c1, a1 = model.convs1
    xp = reflect_pad(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    before = enc1_op.launches
    with torch.no_grad():
        l1, l2 = enc1_op.enc1(xp, c0.weight, c0.bias, a0.weight,
                              c1.weight, c1.bias, a1.weight)
    assert enc1_op.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(l1.permute(0, 2, 3, 1).numpy(), l1_ref,
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(l2.permute(0, 2, 3, 1).numpy(), l2_ref,
                               atol=ATOL, rtol=RTOL)


def test_enc1_gate():
    _, model = _pair()
    x = torch.zeros(1, 3, 104, 104)
    with torch.no_grad():
        assert model.enc1_gate(x)
    assert not model.enc1_gate(x.requires_grad_(True))  # autograd: plain path
    assert not model.enc1_gate(torch.zeros(1, 3, 104, 105))
    _, elu = _pair("ELU")
    with torch.no_grad():
        assert not elu.enc1_gate(torch.zeros(1, 3, 104, 104))
    assert enc1_op.supported(torch.zeros(1, 3, 8, 8), 8)
    assert not enc1_op.supported(torch.zeros(1, 3, 8, 9), 8)


def test_gradients_flow_through_plain_level1():
    _, model = _pair()
    x = torch.rand(1, 3, 104, 104, generator=torch.Generator().manual_seed(0))
    model(x).square().sum().backward()
    assert torch.isfinite(model.convs1[0].weight.grad).all()


@pytest.mark.parametrize("cs,ok", [(504, True), (104, True), (106, False), (16, False)])
def test_check_cs_matches_jax(cs, ok):
    for fn in (check_cs, JaxUtNet.check_cs):
        if ok:
            fn(cs)
        else:
            with pytest.raises(ValueError):
                fn(cs)


@pytest.mark.parametrize("activation", ["PReLU", "ELU", "Hardswish"])
def test_apply_activation_matches_jax(activation):
    from nind_denoise_tpu_torch.ops.conv import apply_activation

    x = np.random.default_rng(7).standard_normal((2, 3, 5, 6)).astype(np.float32) * 4
    a = np.float32(0.2)
    ref = np.asarray(JC.apply_activation(jnp.asarray(x), activation, jnp.asarray(a)))
    got = apply_activation(torch.from_numpy(x), activation, torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
