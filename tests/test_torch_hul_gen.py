"""The port's Hul generators (``models/hul_gen.py``) against the JAX
package's: Hulb128Net (PReLU) and Hulbs128Net (SELU) at funit 2 on one
128 px crop, the forward under each output activation (PReLU, ReLU,
Sigmoid, None), the gradient of the output's sum, and one train step
(MSE with an L1 term). Weights: ``tools/fixtures.hul_gen_params``
(numpy, seeded), through ``hul_gen_state_dict_from_jax``.

Tolerances, float32 on the CPU: forwards 5e-6 absolute (outputs ~0.1-0.6;
seen 2e-7); gradients of the sum 1e-3 of the largest element of each
tensor (seen 1.4e-4 at the head's bias, whose gradient, in the thousands,
sums 16,384 pixels and counts those on each side of the output PReLU's
kink; ~1e-6 elsewhere); the step's losses 1e-6, its gradient 1e-4 of its norm (JAX's
step runs under SGD with a learning rate of 1e3, which hands back the
gradient), and the port's AMSGrad update within two fp32 ulps of optax's
AMSGrad on the port's gradient.
"""

import os

import numpy as np
import optax
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax
import jax.numpy as jnp

from nind_denoise_tpu.models import hul_gen as jax_hul_gen
from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.models import get_network, params_io
from nind_denoise_tpu_torch.models.hul_gen import Hulb128Net, Hulbs128Net
from nind_denoise_tpu_torch.tools import fixtures
from nind_denoise_tpu_torch.train import steps

NETS = ("Hulb128Net", "Hulbs128Net")
ACTS = ("PReLU", "ReLU", "Sigmoid", "None")
FWD_TOL, GRAD_TOL, STEP_GRAD_TOL = 5e-6, 1e-3, 1e-4
WEIGHTS = {"MSE": 1.0, "L1": 0.5}
LR, SGD_LR = 1e-3, 1e3


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch on two threads: the fast tier runs six test processes on one
    host, and these full-width forwards and steps would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed=0):
    return np.random.default_rng(seed).random((1, 128, 128, 3), np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port(params, net, act):
    return params_io.generator_from_state_dict(
        params_io.hul_gen_state_dict_from_jax(params, net), act, net)


def test_get_network_returns_the_hul_generators():
    assert get_network("Hulb128Net") is Hulb128Net
    assert get_network("Hulbs128Net") is Hulbs128Net
    m = Hulbs128Net(2, "Sigmoid")
    assert not hasattr(m, "activation")
    assert isinstance(m.enc128to126std[1], torch.nn.SELU)


@pytest.mark.parametrize("net", NETS)
def test_forward_under_every_output_activation_matches_jax(net):
    cls = getattr(jax_hul_gen, net)
    params = fixtures.hul_gen_params(net, 2, 7)
    fwd = jax.jit(lambda p, x: [cls.apply(p, x, activation=a) for a in ACTS])
    x = _x()
    refs = fwd(params, x)
    for act, ref in zip(ACTS, refs):
        p = params if act == "PReLU" else {k: v for k, v in params.items() if k != "_final_a"}
        model = _port(p, net, act)
        with torch.no_grad():
            got = _nhwc(model(_nchw(x)))
        assert got.shape == (1, 128, 128, 3)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=FWD_TOL, err_msg=act)


@pytest.mark.parametrize("net", NETS)
def test_gradient_of_the_sum_matches_jax(net):
    cls = getattr(jax_hul_gen, net)
    params = fixtures.hul_gen_params(net, 2, 8)
    x = _x(1)
    ref = jax.jit(jax.grad(lambda p, x: cls.apply(p, x, activation="PReLU").sum()))(params, x)
    model = _port(params, net, "PReLU")
    model(_nchw(x)).sum().backward()
    got = params_io.hul_gen_jax_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}, net)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(got)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=jax.tree_util.keystr(path))


def _crops(seed=2):
    rng = np.random.default_rng(seed)
    c = gaussian_filter(rng.random((2, 128, 128, 3)), (0, 2, 2, 0))
    c = ((c - c.min()) / np.ptp(c)).astype(np.float32)
    return c, np.clip(c + rng.normal(0, 0.08, c.shape), 0, 1).astype(np.float32)


def test_train_step_matches_jax():
    net = "Hulb128Net"
    params = fixtures.hul_gen_params(net, 2, 9)
    clean, noisy = _crops()
    sgd = optax.sgd(SGD_LR)
    jstep = jax_steps.make_generator_train_step(
        lambda p, x: jax_hul_gen.Hulb128Net.apply(p, x, activation="PReLU"), sgd,
        WEIGHTS, 120, donate=False)
    js, jm = jstep(jax_steps.TrainState(params, sgd.init(params)), clean, noisy)
    jgrad = np.concatenate([((np.asarray(a) - np.asarray(b)) / SGD_LR).ravel() for a, b in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(js.params))])

    model = _port(params, net, "PReLU")
    state = steps.TrainState(model, steps.make_optimizer(model, LR, 0.9))
    pm = steps.make_generator_train_step(steps.plain_apply, WEIGHTS, 120)(
        state, _nchw(clean), _nchw(noisy))
    for k in jm:
        assert abs(float(pm[k]) - float(jm[k])) < 1e-6, k
    got_g = params_io.hul_gen_jax_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}, net)
    pgrad = np.concatenate([g.ravel() for g in jax.tree_util.tree_leaves(got_g)])
    assert np.linalg.norm(pgrad - jgrad) <= STEP_GRAD_TOL * np.linalg.norm(jgrad)
    ams = jax_steps.make_optimizer(LR, 0.9)
    ams_step = jax.jit(lambda g, p: optax.apply_updates(p, ams.update(g, ams.init(p), p)[0]))
    want = ams_step(got_g, params)
    got = params_io.hul_gen_jax_from_state_dict(model.state_dict(), net)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=2 * 2 ** -23 * max(
            1.0, float(np.abs(np.asarray(a)).max())))


def test_bf16_apply_runs_the_hul_generator_in_bf16():
    """``--compute_dtype bfloat16``'s forward: bf16 inside, fp32 out, within
    bf16 rounding of the fp32 forward (2^-6 of the output's range)."""
    params = fixtures.hul_gen_params("Hulbs128Net", 2, 10)
    model = _port(params, "Hulbs128Net", "PReLU")
    x = _nchw(_x(3))
    with torch.no_grad():
        ref, got = model(x), steps.bf16_apply(model, x)
    assert got.dtype == torch.float32
    assert (got - ref).abs().max() <= 2 ** -6 * (ref.max() - ref.min())
    assert not torch.equal(got, ref)


@pytest.mark.parametrize("net,dtype", [("Hulb128Net", "float32"), ("Hulbs128Net", "bfloat16")])
def test_trainer_runs_the_hul_generators(tmp_path, net, dtype):
    """``train.loop --g_network Hulb128Net|Hulbs128Net`` with the reference's
    flags cut to the CPU (funit 2, batch 2, 128 px crops, MSE on 120 px)
    for one epoch, fp32 and bf16; its checkpoint loads into JAX's
    ``params_io`` and gives the port's forward there."""
    from nind_denoise_tpu.models import params_io as jax_params_io
    from nind_denoise_tpu_torch.train import loop

    import cv2

    root = tmp_path / "SYN_144_128"
    rng = np.random.default_rng(4)
    for xx in (0, 144):
        clean = gaussian_filter(rng.random((144, 144, 3)), (3, 3, 0))
        clean = (clean - clean.min()) / np.ptp(clean)
        for iso, sigma in (("ISO200", 0.0), ("ISO3200", 0.08)):
            d = root / "s0" / iso
            d.mkdir(parents=True, exist_ok=True)
            img = np.clip(clean + rng.normal(0, sigma, clean.shape), 0, 1)
            cv2.imwrite(str(d / f"SYN_s0_{iso}_{xx}_0_128.png"), (img * 65535).astype(np.uint16))
    exp = loop.main(["--train_data", str(root), "--test_reserve", "0", "--g_network", net,
                     "--g_funit", "2", "--cs", "128", "--loss_cs", "120", "--batch_size", "2",
                     "--weight_MSSSIM", "0", "--weight_MSE", "1", "--g_lr", "1e-4",
                     "--beta1", "0.5", "--epochs", "2", "--validation_interval", "0",
                     "--threads", "1", "--device", "cpu", "--compute_dtype", dtype,
                     "--models_dpath", str(tmp_path / "m")])
    ck = os.path.join(exp, "generator_1.npz")
    model = params_io.load_generator(ck, net)
    params, state = jax_params_io.load_generator(ck, net)
    assert state is None
    x = _x(5)
    ref = jax.jit(lambda p, x: getattr(jax_hul_gen, net).apply(p, x))(params, x)
    with torch.no_grad():
        got = _nhwc(model(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=FWD_TOL)
