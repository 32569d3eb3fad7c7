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


# -- UNet and the Hul generators, and convert_checkpoint ------------------------

def _unet():
    from nind_denoise_tpu_torch.tools import fixtures

    return fixtures.unet_tree(1)


def _hul_gen(net):
    from nind_denoise_tpu_torch.tools import fixtures

    return fixtures.hul_gen_params(net, 2, 4)


def _assert_same_tree(a, b):
    fa, fb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [jax.tree_util.keystr(k) for k, _ in fa] == [jax.tree_util.keystr(k) for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("net", ["UNet", "Hulb128Net", "Hulbs128Net"])
def test_generator_state_dicts_equal_torch_export_and_round_trip(net):
    """The port's mapping is ``torch_export.export_unet`` /
    ``export_hul_gen`` key for key, loads strictly into the port's module,
    and maps back to the JAX tree bit for bit."""
    if net == "UNet":
        params, state = _unet()
        ref = torch_export.export_unet(params, state)
    else:
        params, state = _hul_gen(net), None
        ref = torch_export.export_hul_gen(params, net)
    ours = params_io.generator_state_dict_from_jax(net, params, state)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = params_io.generator_from_state_dict(ours, "PReLU", net)
    assert set(model.state_dict()) == set(ours)
    back_p, back_s = params_io.generator_jax_from_state_dict(net, model.state_dict())
    _assert_same_tree(back_p, params)
    if net == "UNet":
        _assert_same_tree(back_s, state)
    else:
        assert back_s is None


def test_unet_npz_without_state_raises(tmp_path):
    params, _ = _unet()
    path = str(tmp_path / "generator_1.npz")
    jax_params_io.save(params, path)
    with pytest.raises(ValueError, match="BatchNorm state"):
        params_io.load_generator(path, "UNet")


def _pt_of(net, path):
    """A torch checkpoint of ``net`` in the reference's layout."""
    from nind_denoise_tpu_torch.models import HulDisc

    if net == "UtNet":
        from nind_denoise_tpu_torch.tools import fixtures

        fixtures.write_jax_checkpoint(path + ".npz", 4, seed=8)
        sd = params_io.state_dict_from_jax(params_io.load_npz(path + ".npz"))
    elif net == "UNet":
        sd = params_io.unet_state_dict_from_jax(*_unet())
    elif net.endswith("128Net"):
        sd = params_io.hul_gen_state_dict_from_jax(_hul_gen(net), net)
    else:
        torch.manual_seed(0)
        m = HulDisc(net, funit=2)
        for b in m.modules():  # running stats away from their init
            if isinstance(b, torch.nn.BatchNorm2d):
                b.running_mean.uniform_(-0.1, 0.1)
                b.running_var.uniform_(0.5, 1.5)
        sd = m.state_dict()
    torch.save(sd, path)
    return sd


CONVERT_NETS = ["UtNet", "UNet", "Hul112Disc", "Hulb112Disc", "Hull112Disc", "Hulf112Disc",
                "Hulb128Net", "Hulbs128Net"]


@pytest.mark.parametrize("net", CONVERT_NETS)
def test_convert_checkpoint_matches_the_jax_tool(tmp_path, net):
    """``.pt`` -> ``.npz`` and back: the port's tool writes the arrays and
    tensors JAX's tool writes, key for key, bit for bit."""
    from nind_denoise_tpu.tools import convert_checkpoint as jax_tool
    from nind_denoise_tpu_torch.tools import convert_checkpoint as port_tool

    src = str(tmp_path / "g.pt")
    sd = _pt_of(net, src)
    for side, tool in (("jax", jax_tool), ("port", port_tool)):
        tool.main([src, str(tmp_path / f"{side}.npz"), "--network", net])
        tool.main([str(tmp_path / "jax.npz"), str(tmp_path / f"{side}.pt"), "--network", net])
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    a, b = (torch.load(tmp_path / f"{s}.pt", weights_only=True) for s in ("jax", "port"))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert set(b) == set(sd)  # the reference's keys


def test_convert_checkpoint_refuses_what_is_not_ported(tmp_path):
    """MobileNetV3 converts forward (tests/test_torch_third_party.py holds the
    tree to JAX's) and its reverse raises, as in JAX."""
    from nind_denoise_tpu_torch.models import build
    from nind_denoise_tpu_torch.tools import convert_checkpoint as port_tool

    torch.save(build("MobileNetV3").state_dict(), str(tmp_path / "m.pt"))
    port_tool.main([str(tmp_path / "m.pt"), "--network", "MobileNetV3"])
    tree = params_io.load_npz(str(tmp_path / "m.npz"))
    assert sorted(tree) == ["params", "state"] and len(tree["params"]["backbone"]) == 17
    with pytest.raises(NotImplementedError, match="torch export for MobileNetV3"):
        port_tool.main([str(tmp_path / "m.npz"), "--network", "MobileNetV3"])
