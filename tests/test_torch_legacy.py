"""The port's legacy denoisers (``models/legacy.py``: DnCNN, RedCNN)
against the JAX package's, on the CPU; the front ends' refusal of them;
and ``denoise_image_cli --trace_dir``.

Weights drawn from a numpy seed (``tools/fixtures.seed_zoo_module``, every
BatchNorm's scale, bias and running stats too, so that the mapping of each
is exercised) at depth 6 and 8 channels for DnCNN and depth 10 and 8
channels for RedCNN, in JAX's layout through ``params_io`` (the layout held
to JAX's init, traced); numpy-seeded inputs, 40 and 48 px.

Tolerances, float32: forwards and the BN running stats 5e-5 absolute, as
the Hul and UNet tests hold theirs (seen ~1e-6); the state_dict mapping
both ways bit-exact.
"""

import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nind_denoise_tpu.models import legacy as jax_legacy
from nind_denoise_tpu_torch.models import build, get_network, params_io
from nind_denoise_tpu_torch.pipeline import denoise_image_cli as port_image_cli
from nind_denoise_tpu_torch.tools import convert_checkpoint, fixtures

ATOL = 5e-5
DEPTH, CH = 6, 8
RED_DEPTH = 10


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jax_layout(network, **kw):
    """JAX's init traced (``jax.eval_shape``: nothing compiled) to its
    leaves' paths and shapes."""
    tree = jax.eval_shape(lambda k: getattr(jax_legacy, network).init(k, **kw),
                          jax.random.PRNGKey(0))
    return [(p, tuple(x.shape)) for p, x in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.fixture(scope="module")
def dncnn():
    """Seeded weights (every BatchNorm's scale, bias and stats drawn) in
    JAX's layout, through ``params_io``."""
    model = fixtures.seed_zoo_module(build("DnCNN", depth=DEPTH, n_channels=CH), 1)
    return params_io.zoo_jax_from_state_dict("DnCNN", model.state_dict())


@pytest.fixture(scope="module")
def redcnn():
    model = fixtures.seed_zoo_module(build("RedCNN", n_channels=CH, depth=RED_DEPTH), 2)
    return params_io.zoo_jax_from_state_dict("RedCNN", model.state_dict())[0]


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape, np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port_dncnn(tree, find_noise=True):
    sd = params_io.zoo_state_dict_from_jax("DnCNN", *tree)
    model = params_io.generator_from_state_dict(sd, network="DnCNN")
    model.find_noise = find_noise
    return model


@pytest.mark.parametrize("train,find_noise", [(False, True), (True, True), (False, False)])
def test_dncnn_forward_and_bn_state_match_jax(dncnn, train, find_noise):
    params, state = dncnn
    x = _x((2, 40, 40, 3))
    fwd = jax.jit(lambda p, x, s: jax_legacy.DnCNN.apply(p, x, s, train=train,
                                                         find_noise=find_noise))
    ref, ref_state = fwd(params, x, state)
    model = _port_dncnn(dncnn, find_noise).train(train)
    with torch.no_grad():
        got = model(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)
    _, got_state = params_io.zoo_jax_from_state_dict("DnCNN", model.state_dict())
    assert sorted(got_state) == sorted(ref_state)
    for k in ref_state:
        for s in ("mean", "var"):
            np.testing.assert_allclose(got_state[k][s], np.asarray(ref_state[k][s]),
                                       rtol=0, atol=ATOL, err_msg=f"{k}/{s}")
    moved = any(not np.array_equal(got_state[k]["mean"], state[k]["mean"]) for k in state)
    assert moved == train
    # eps 1e-4 and momentum 0.95 at every site
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == DEPTH - 2 and {(m.eps, m.momentum) for m in bns} == {(1e-4, 0.95)}


def test_redcnn_forward_matches_jax_with_tied_weights(redcnn):
    x = _x((2, 48, 48, 3), 1)
    ref = jax.jit(lambda p, x: jax_legacy.RedCNN.apply(p, x, depth=RED_DEPTH))(redcnn, x)
    sd = params_io.zoo_state_dict_from_jax("RedCNN", redcnn)
    model = get_network("RedCNN")(**get_network("RedCNN").config_of(sd, depth=RED_DEPTH))
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.shape == (2, 3, 48, 48)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)
    # one conv and one deconv serve every depth step
    assert sorted(sd) == sorted(f"{m}.{p}" for m in ("conv", "conv_first", "deconv",
                                                      "deconv_last") for p in ("bias", "weight"))
    assert tuple(model.deconv.weight.shape) == (CH, CH, 5, 5)


@pytest.mark.parametrize("network", ["DnCNN", "RedCNN"])
def test_state_dict_mapping_is_exact_both_ways(dncnn, redcnn, network):
    """The mapped tree has JAX's init layout, and the mapping is exact
    both ways."""
    params, state = dncnn if network == "DnCNN" else (redcnn, None)
    kw = {"depth": DEPTH} if network == "DnCNN" else {"depth": RED_DEPTH}
    layout = _jax_layout(network, n_channels=CH, **kw)
    mapped = jax.tree_util.tree_leaves_with_path((params, state) if state else params)
    if state is not None:
        layout = [((jax.tree_util.SequenceKey(0),) + p[1:], s) if p[0].idx == 0 else
                  ((jax.tree_util.SequenceKey(1),) + p[1:], s) for p, s in layout]
    assert [(p, s) for p, s in layout] == [(p, x.shape) for p, x in mapped]
    sd = params_io.zoo_state_dict_from_jax(network, params, state)
    back_p, back_s = params_io.zoo_jax_from_state_dict(network, sd)
    ref = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back_p)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, got):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    if state is None:
        assert back_s is None
    else:
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(state),
                                     jax.tree_util.tree_leaves_with_path(back_s)):
            assert np.array_equal(a, b), path
    # and the port's own state_dict through JAX's layout and back
    torch.manual_seed(3)
    model = build(network, depth=DEPTH if network == "DnCNN" else RED_DEPTH, n_channels=CH)
    own = model.state_dict()
    again = params_io.zoo_state_dict_from_jax(network, *params_io.zoo_jax_from_state_dict(
        network, own))
    assert sorted(again) == sorted(own)
    for k in own:
        assert torch.equal(again[k], own[k]), k


def test_load_generator_reads_a_jax_npz(dncnn, tmp_path):
    params, state = dncnn
    fpath = str(tmp_path / "generator_1.npz")
    params_io.save({"params": params, "state": state}, fpath)
    model = params_io.load_generator(fpath, "DnCNN").eval()
    x = _x((1, 40, 40, 3), 2)
    ref, _ = jax_legacy.DnCNN.apply(params, jnp.asarray(x), state, train=False)
    with torch.no_grad():
        got = model(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("network", ["DnCNN", "RedCNN", "ResnetGenerator"])
def test_convert_checkpoint_has_no_mapping_for_the_zoo(tmp_path, network):
    """As in the JAX package, whose torch_import/torch_export map none of
    them; nothing is written."""
    with pytest.raises(NotImplementedError, match="no torch mapping"):
        convert_checkpoint.main([str(tmp_path / "m.pt"), str(tmp_path / "m.npz"),
                                 "--network", network])
    assert not os.listdir(tmp_path)


# -- --trace_dir -------------------------------------------------------------------


def test_trace_dir_writes_a_trace_and_leaves_the_output_unchanged(tmp_path):
    rng = np.random.default_rng(4)
    tif = str(tmp_path / "img.tif")
    cv2.imwrite(tif, rng.integers(0, 65536, (150, 170, 3)).astype(np.uint16))
    ckpt = str(tmp_path / "generator_1.npz")
    fixtures.write_jax_checkpoint(ckpt, 4, 0)
    argv = ["-i", tif, "--network", "UtNet", "--model_path", ckpt, "--cs", "104",
            "--ucs", "88", "--device", "cpu", "--compute_dtype", "float32"]
    plain = port_image_cli.main(argv + ["-o", str(tmp_path / "plain.tif")])
    traced = port_image_cli.main(argv + ["-o", str(tmp_path / "traced.tif"),
                                         "--trace_dir", str(tmp_path / "trace")])
    a, b = (cv2.imread(p, cv2.IMREAD_UNCHANGED) for p in (plain, traced))
    assert a.dtype == np.uint16 and np.array_equal(a, b)
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::conv2d" in names  # the run's own operators, on the host
