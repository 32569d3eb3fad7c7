"""The port's Hul discriminators (``models/hul.HulDisc``) against the JAX
package's ``models/hul.py``, and their checkpoints in both directions.

All four variants at funit 2 on seeded 2 x 130 px batches (a 3 x 3
prediction map): eval mode with perturbed running stats, and train mode
with the updated BN state. The weights are the port's seeded torch init,
carried to JAX by ``hul_jax_from_state_dict`` (JAX's own eager init
costs half a minute on the CPU). Tolerance 5e-5 absolute, as the JAX package holds
its Hul forward to the reference's torch modules
(tests/test_models_zoo.py); the BN running stats to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nind_denoise_tpu.models import hul as jax_hul
from nind_denoise_tpu.models import torch_export, torch_import
from nind_denoise_tpu_torch.models import get_network, params_io
from nind_denoise_tpu_torch.models.hul import HulDisc

VARIANTS = [("Hul112Disc", 3), ("Hulb112Disc", 3), ("Hull112Disc", 3), ("Hulf112Disc", 6)]
ATOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch's default threads under the fast tier's parallel workers
    oversubscribe the host: two a worker, as test_torch_train_gan_cli.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_nets():
    """JAX (params, BN state) of each variant from a seeded port init,
    the running stats moved off their init so that eval mode reads them."""
    out = {}
    rng = np.random.default_rng(0)
    for k, (net, cin) in enumerate(VARIANTS):
        torch.manual_seed(k)
        params, state = params_io.hul_jax_from_state_dict(HulDisc(net, cin, 2).state_dict(), net)
        state = jax.tree_util.tree_map(
            lambda a: a + rng.random(a.shape).astype(np.float32) * 0.2, state)
        out[net] = (params, state)
    return out


def _port(net, cin, jax_nets):
    m = HulDisc(net, cin, 2)
    m.load_state_dict(params_io.hul_state_dict_from_jax(*jax_nets[net], net), strict=True)
    return m


def _x(cin, hw=130, seed=7):
    return np.random.default_rng(seed).random((2, cin, hw, hw), dtype=np.float32)


@pytest.mark.parametrize("net,cin", VARIANTS)
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(net, cin, train, jax_nets):
    params, state = jax_nets[net]
    m = _port(net, cin, jax_nets).train(train)
    x = _x(cin)
    ref, new_state = getattr(jax_hul, net).apply(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)), state, train=train)
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    got = m(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, 1, 3, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    # the running stats moved as JAX's (train) or not at all (eval)
    _, st = params_io.hul_jax_from_state_dict(m.state_dict(), net)
    leaves = jax.tree_util.tree_leaves(st)
    assert len(leaves) == len(jax.tree_util.tree_leaves(state))
    for a, b in zip(leaves, jax.tree_util.tree_leaves(new_state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("net,cin", VARIANTS)
def test_state_dict_mapping_both_ways_equals_jax(net, cin, jax_nets):
    params, state = jax_nets[net]
    sd = params_io.hul_state_dict_from_jax(params, state, net)
    ref = torch_export.export_hul_disc(params, state, net)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    # the reference's module names: the port's own state_dict has the keys
    assert sorted(HulDisc(net, cin, 2).state_dict()) == sorted(ref)
    p2, s2 = params_io.hul_jax_from_state_dict(sd, net)
    jp, js = torch_import.import_hul_disc({k: torch.from_numpy(np.array(v))
                                           for k, v in ref.items()}, net)
    assert jax.tree_util.tree_structure(p2) == jax.tree_util.tree_structure(jp)
    assert jax.tree_util.tree_structure(s2) == jax.tree_util.tree_structure(js)
    for a, b in zip(jax.tree_util.tree_leaves((p2, s2)), jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_array_equal(a, b)


def test_finalpool_heads_are_rejected_by_both(jax_nets):
    sd = params_io.hul_state_dict_from_jax(*jax_nets["Hul112Disc"], "Hul112Disc")
    sd["decide.0.weight"] = sd["decide.0.weight"][:, :, :1, :1].clone()
    with pytest.raises(ValueError, match="finalpool"):
        params_io.hul_jax_from_state_dict(sd, "Hul112Disc")
    with pytest.raises(ValueError, match="finalpool"):
        torch_import.import_hul_disc(sd, "Hul112Disc")


@pytest.mark.parametrize("net,cin", [VARIANTS[0], VARIANTS[3]])
def test_pt_files_cross_both_ways(net, cin, jax_nets, tmp_path):
    """A port ``.pt`` (after a train-mode forward moved its stats) loads in
    JAX's ``import_hul_disc`` and gives the port's eval forward; a ``.pt``
    written by JAX's ``export_hul_disc`` loads through the port's
    ``load_discriminator``."""
    m = _port(net, cin, jax_nets)
    m(torch.from_numpy(_x(cin, seed=1)))
    m.eval()
    port_pt = str(tmp_path / "discriminator_4.pt")
    torch.save(m.state_dict(), port_pt)
    params, state = torch_import.import_hul_disc(port_pt, net)
    x = _x(cin, seed=2)
    ref, _ = getattr(jax_hul, net).apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)), state)
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2), rtol=0, atol=ATOL)

    jax_pt = str(tmp_path / "discriminator_5.pt")
    torch_export.save_pt(torch_export.export_hul_disc(*jax_nets[net], net), jax_pt)
    loaded = params_io.load_discriminator(str(tmp_path), net)  # the highest epoch
    assert loaded["opt"] is None and loaded["sched"] is None
    got = params_io.hul_state_dict_from_jax(loaded["params"], loaded["state"], net)
    ref = params_io.hul_state_dict_from_jax(*jax_nets[net], net)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("net,cin", [VARIANTS[0], VARIANTS[2]])
def test_frozen_forward_leaves_the_module_untouched(net, cin, jax_nets):
    """``frozen=True`` (the generator's fooling term): the batch's
    statistics as in train mode, and no buffer, parameter or gradient of
    the discriminator changes; the gradient reaches the input."""
    m = _port(net, cin, jax_nets).train()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    x = torch.from_numpy(_x(cin)).requires_grad_(True)
    y = m(x, frozen=True)
    y.square().mean().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert all(p.grad is None for p in m.parameters())
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the same normalization as the updating train-mode forward
    ref, _ = getattr(jax_hul, net).apply(jax_nets[net][0], jnp.asarray(
        x.detach().numpy().transpose(0, 2, 3, 1)), jax_nets[net][1], train=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=0, atol=ATOL)
    assert torch.equal(m(x.detach(), frozen=True), y.detach())


@pytest.mark.parametrize("net,cin", [VARIANTS[0], VARIANTS[2]])
def test_frozen_forward_takes_batch_statistics_in_eval_mode_too(net, cin, jax_nets):
    """``frozen=True`` ignores the module's mode (JAX's ``pred_fn`` always
    applies ``train=True``); eval mode without it uses the running stats."""
    m = _port(net, cin, jax_nets)
    x = torch.from_numpy(_x(cin))
    with torch.no_grad():
        train_frozen = m.train()(x, frozen=True)
        eval_frozen = m.eval()(x, frozen=True)
        eval_running = m(x)
    assert torch.equal(eval_frozen, train_frozen)
    ref, _ = getattr(jax_hul, net).apply(jax_nets[net][0], jnp.asarray(_x(cin).transpose(0, 2, 3, 1)),
                                         jax_nets[net][1], train=False)
    np.testing.assert_allclose(eval_running.numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=0, atol=ATOL)
    assert not torch.allclose(eval_running, eval_frozen, rtol=0, atol=ATOL)


def test_get_network_names_item_7_for_the_rest_of_the_zoo():
    """The legacy and pix2pix zoo resolves (tests/test_torch_{legacy,p2p}.py),
    and so do the relic zoo and the torchvision networks
    (tests/test_torch_{relics,third_party}.py): every name of JAX's registry."""
    assert get_network("Hulf112Disc") is HulDisc
    assert get_network("UtNet").__name__ == "UtNet"
    assert get_network("UNet").__name__ == "UNet"
    for name, cls in (("NLayerDiscriminator", "NLayerDiscriminator"),
                      ("PatchGAN", "NLayerDiscriminator"),
                      ("PixelDiscriminator", "PixelDiscriminator"), ("DnCNN", "DnCNN")):
        assert get_network(name).__name__ == cls
    for name in ("HunkyDisc", "Hul144Disc", "MobileNetV3"):
        assert get_network(name).__name__ == name
    from nind_denoise_tpu.models import get_network as jax_get_network

    for name in ("RedishCNN", "HunkyDisc", "HunkyNet", "HunNet", "HuNet", "HuDisc",
                 "Hul144Disc", "Hul128Net", "Hul160Net", "HulNet", "MobileNetV3",
                 "deeplabv3_resnet101"):
        assert get_network(name).__name__ == jax_get_network(name).__name__, name
    with pytest.raises(KeyError, match="unknown network"):
        get_network("NoSuchNet")
