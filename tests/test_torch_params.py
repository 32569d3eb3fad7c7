"""The port's checkpoint loading against the JAX package: the weight
mapping (state_dict_from_jax vs torch_export.export_utnet), strict loads,
and .npz / .pt files written by the JAX package."""

import numpy as np
import pytest
import torch

import jax

from nind_denoise_tpu.models import params_io as jax_params_io
from nind_denoise_tpu.models import torch_export
from nind_denoise_tpu.models.utnet import UtNet as JaxUtNet
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.models.utnet import UtNet


def _params(activation="PReLU", funit=8, seed=0):
    p = JaxUtNet.init(jax.random.PRNGKey(seed), funit=funit, activation=activation)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("activation", ["PReLU", "ELU", "Hardswish"])
def test_state_dict_from_jax_loads_strictly(activation):
    sd = params_io.state_dict_from_jax(_params(activation))
    m = UtNet(8, activation)
    m.load_state_dict(sd, strict=True)
    assert UtNet.funit_of(sd) == 8


@pytest.mark.parametrize("activation", ["PReLU", "ELU"])
def test_state_dict_from_jax_equals_torch_export(activation):
    params = _params(activation, seed=3)
    ours = params_io.state_dict_from_jax(params)
    ref = torch_export.export_utnet(params)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def _assert_same_weights(model, params):
    ref = torch_export.export_utnet(params)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("bundled", [False, True])
def test_load_generator_npz(tmp_path, bundled):
    params = _params(seed=5)
    path = str(tmp_path / "generator_1.npz")
    jax_params_io.save({"params": params, "state": None} if bundled else params,
                       path)
    model = params_io.load_generator(path)
    assert model.activation == "PReLU"
    _assert_same_weights(model, params)


def test_load_generator_pt(tmp_path):
    params = _params(seed=6)
    path = str(tmp_path / "generator_1.pt")
    torch_export.save_pt(torch_export.export_utnet(params), path)
    _assert_same_weights(params_io.load_generator(path), params)


def test_load_generator_rejects_unknown_format(tmp_path):
    with pytest.raises(ValueError):
        params_io.load_generator(str(tmp_path / "generator_1.bin"))
