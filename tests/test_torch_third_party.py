"""The port's torchvision experiments (``models/third_party.py``) against
the JAX package's on the CPU: MobileNetV3 (LR-ASPP MobileNetV3-Large) and
the ``deeplabv3_resnet101`` stub, and MobileNetV3 through
``convert_checkpoint``.

Weights, every BatchNorm's scale, bias and stats drawn from a numpy seed
(``fixtures.seed_zoo_module``) in the port's module, which holds
torchvision's state_dict names; JAX's tree from them through
``params_io``, its layout held to JAX's init traced with
``jax.eval_shape`` (nothing compiled). The forward runs with running
stats calibrated to one forward's batch statistics (random stats grow the
output to ~280). Inputs 96 x 96, 112 x 128 and 128 x 128 px,
numpy-seeded.

Tolerances: the eval forward float32 within 1e-5 of the output's largest
magnitude (5-21 here; seen 6e-6 of it: either package's fp32 lies 3-6e-6
of it from the port's float64 forward, as the head's 960-channel 1x1
convs sum); the mapping both ways and ``convert_checkpoint``'s tree
against JAX's ``import_mobilenetv3`` (JAX's own tool) bit-exact.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from nind_denoise_tpu.models import third_party as jax_tp
from nind_denoise_tpu.tools import convert_checkpoint as jax_tool
from nind_denoise_tpu_torch.models import build, get_network, params_io, third_party
from nind_denoise_tpu_torch.tools import convert_checkpoint as port_tool
from nind_denoise_tpu_torch.tools import fixtures

REL_TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    return fixtures.seed_zoo_module(build("MobileNetV3"), 3).eval()


@pytest.fixture(scope="module")
def calibrated(model):
    """``model`` with each BatchNorm's running stats set to the batch's of
    one forward (each BatchNorm in train mode, momentum 1: the network
    refuses a train-mode forward)."""
    m = copy.deepcopy(model)
    bns = [b for b in m.modules() if isinstance(b, torch.nn.BatchNorm2d)]
    for b in bns:
        b.momentum = 1.0
        b.train()
    with torch.no_grad():
        m(torch.from_numpy(np.random.default_rng(9).random((4, 3, 96, 96), np.float32)))
    for b in bns:
        b.momentum = 0.1
        b.eval()
    return m


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_tables_are_jax_s():
    assert third_party.LARGE_DILATED == jax_tp._LARGE_DILATED
    assert third_party.LOW_TAP == jax_tp._LOW_TAP
    assert (third_party.BN_EPS_BACKBONE, third_party.BN_EPS_HEAD) == \
        (jax_tp._BN_EPS_BACKBONE, jax_tp._BN_EPS_HEAD)
    for v in (4, 16, 18, 60, 120, 168, 240):
        assert third_party.make_divisible(v) == jax_tp.make_divisible(v)


@pytest.mark.parametrize("hw", [(96, 96), (112, 128), (128, 128)])
def test_eval_forward_matches_jax(calibrated, hw):
    params, state = params_io.mobilenet_jax_from_state_dict(calibrated.state_dict())
    x = np.random.default_rng(hw[1]).random((2, *hw, 3), np.float32)
    ref, _ = jax.jit(lambda p, x, s: jax_tp.MobileNetV3.apply(p, x, s))(params, x, state)
    with torch.no_grad():
        got = calibrated(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert tuple(got.shape) == (2, 3, *hw)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


def test_train_mode_raises_in_both(model):
    params, state = params_io.mobilenet_jax_from_state_dict(model.state_dict())
    x = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(NotImplementedError, match="pretrained-inference only"):
        jax_tp.MobileNetV3.apply(params, x, state, train=True)
    with pytest.raises(NotImplementedError, match="pretrained-inference only"):
        build("MobileNetV3").train()(torch.zeros(1, 3, 64, 64))


def test_state_dict_mapping_is_exact_both_ways(model):
    """JAX's init layout (traced), key for key and shape for shape; the
    mapping exact both ways; the parameters alone map without a state."""
    sd = model.state_dict()
    params, state = params_io.mobilenet_jax_from_state_dict(sd)
    layout = jax.eval_shape(jax_tp.MobileNetV3.init, jax.random.PRNGKey(0))
    for a, b in zip(layout, (params, state)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        assert [(p, tuple(x.shape)) for p, x in _leaves(a)] == [(p, x.shape) for p, x in _leaves(b)]
    back = params_io.mobilenet_state_dict_from_jax(params, state)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
    p_only = params_io.mobilenet_state_dict_from_jax(params)
    assert sorted(p_only) == sorted(k for k, _ in model.named_parameters())
    again, st = params_io.mobilenet_jax_from_state_dict(p_only)
    assert st is None
    for (path, u), (_, v) in zip(_leaves(params), _leaves(again)):
        assert np.array_equal(u, v), path
    # the registry's generator mapping dispatches to it
    assert params_io.generator_jax_from_state_dict("MobileNetV3", sd)[1] is not None
    loaded = params_io.generator_from_state_dict(
        params_io.generator_state_dict_from_jax("MobileNetV3", params, state), network="MobileNetV3")
    assert isinstance(loaded, third_party.MobileNetV3)


@pytest.mark.parametrize("prefix", ["", "net."])
def test_convert_checkpoint_matches_jax_import(tmp_path, model, prefix):
    """``.pt`` -> ``.npz``: the port's tool writes the tree JAX's tool
    (``torch_import.import_mobilenetv3``) writes, key for key, bit for bit,
    from torchvision's state_dict and from the reference wrapper's
    (``net.``); the reverse direction raises in both."""
    src = str(tmp_path / "m.pt")
    torch.save({prefix + k: v for k, v in model.state_dict().items()}, src)
    for side, tool in (("jax", jax_tool), ("port", port_tool)):
        tool.main([src, str(tmp_path / f"{side}.npz"), "--network", "MobileNetV3"])
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for tool in (jax_tool, port_tool):
        with pytest.raises(NotImplementedError, match="torch export for MobileNetV3"):
            tool.main([str(tmp_path / "port.npz"), str(tmp_path / "back.pt"), "--network",
                       "MobileNetV3"])


def test_deeplab_raises_in_both():
    assert get_network("deeplabv3_resnet101") is third_party.deeplabv3_resnet101
    with pytest.raises(NotImplementedError, match="unimplemented upstream"):
        jax_tp.deeplabv3_resnet101.init(jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="unimplemented upstream"):
        build("deeplabv3_resnet101")
