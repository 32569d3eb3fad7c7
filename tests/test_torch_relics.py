"""The port's relic zoo (``models/relics.py``) against the JAX package's
on the CPU, and the relic discriminators in the port's cGAN against JAX's
discriminator wrapper.

Forwards: funit 2 (the Hu family at 160 px, Hul128Net at 128, Hul144Disc
at 144, batch 2), HunkyDisc at 256 px and HunkyNet at 224 px at batch 1
with their absolute widths, RedishCNN at 8 channels and depth 30 at 112
px. Weights, every BatchNorm's scale, bias and stats and every PReLU's
slope drawn from a numpy seed (``fixtures.seed_zoo_module``) in the port's
module, in JAX's layout through ``params_io``; RedishCNN's one BatchNorm,
shared by 48 uses, takes the cumulative mean of the stats of one
train-mode forward (random stats there grow its eval output to ~2.5e5).
JAX's eager init is never called (5-37 s a network): its layout is traced
with ``jax.eval_shape``. Eval and train mode, the new running stats, the
frozen forward, both Hul144Disc heads; the mapping both ways.

HunkyNet's train-mode forward runs at batch 2 and 256 px: torch's
BatchNorm refuses one value a channel in train mode, which its 1 x 1
bottom gives at batch 1 and 224 px (JAX normalizes it to the bias).

The cGAN: JAX's wrapper with ``--d_network HuDisc`` or ``Hul144Disc`` at
funit 2 takes an Adam step on a seeded gradient, moves its plateau
scheduler and saves; the port resumes from that file and both take one
step from that common state on seeded 2 x 192 px batches (184 px crops)
with JAX's fuzzy targets, JAX's in float64; a port checkpoint resumes in
JAX's wrapper exactly; a two-epoch ``train.loop``
runs with HuDisc as D1 and Hul144Disc as D2 at loss_cs 184 and resumes;
HunkyDisc is refused there (its prediction map is empty below 256 px).

Tolerances, float32: forwards and BN stats 5e-5 absolute (seen 2e-5 at
most), HunkyNet's train-mode forward 1e-4 (seen 7e-5: the port's fp32
lies 4e-5 and JAX's 6.6e-5 from the port's float64 there, 1024-channel
convs under BatchNorm over eight values a channel); the mapping
bit-exact. The step, from the common state: losses, prediction ranges and
the BN running stats 1e-5 absolute; the port's float64 gradient against
JAX's step run in float64 within 1e-6 of each tensor's largest entry
(seen 5e-8), the port's fp32 gradient against its float64 one within
3e-3 (seen 3-6e-4 here, 1.5e-3 from another common state: a conv weight's
gradient in Hul144Disc's dual branch, summed over 30k pixels under
BatchNorm), elements 0 in float64 (the head Hul144Disc does not run) 0 in
both; the update optax's
Adam on the port's gradient within 2.5e-7 absolute, its moments 1e-6
relative.
"""

import contextlib
import os
import re
import types

import cv2
import numpy as np
import pytest
import torch
import yaml
from scipy.ndimage import gaussian_filter

import jax
import jax.numpy as jnp
import optax

from nind_denoise_tpu.models import norm as jax_norm
from nind_denoise_tpu.models import relics as jax_relics
from nind_denoise_tpu.train import gan as jax_gan
from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.models import (RELICS, build, get_network, is_discriminator,
                                           params_io, relics)
from nind_denoise_tpu_torch.tools import disc_step_noise, fixtures
from nind_denoise_tpu_torch.train import gan, loop

ATOL, HUNKY_TRAIN_ATOL = 5e-5, 1e-4
TOL = 1e-5
F64_TOL, GRAD_TOL, ZERO_TOL, ADAM_TOL = 1e-6, 3e-3, 1e-5, 2.5e-7
LR = 1e-4
ARGS = types.SimpleNamespace(beta1=0.5, models_dpath=None)
CS, LOSS_CS = 192, 184
# XLA's backend optimization level 1 for the JAX references' compiles: the
# same function, compiled in half the time (the x64 step: 3.6 s, not 7.3)
FAST_COMPILE = {"xla_backend_optimization_level": 1}
NAMES = ("HunNet", "HuNet", "Hul160Net", "HulNet", "HuDisc", "Hul128Net", "Hul144Disc",
         "HunkyDisc", "HunkyNet", "RedishCNN")
# name -> (constructor / JAX init arguments, eval input NHWC, train input NHWC)
CASES = {
    "HunNet": (dict(funit=2), (2, 160, 160, 3), None),
    "HuNet": (dict(funit=2), (2, 160, 160, 3), None),
    "Hul160Net": (dict(funit=2), (2, 160, 160, 3), None),
    "HulNet": (dict(funit=2), (2, 160, 160, 3), None),
    "HuDisc": (dict(funit=2), (2, 160, 160, 3), None),
    "Hul128Net": (dict(funit=2), (2, 128, 128, 3), None),
    "Hul144Disc": (dict(funit=2), (2, 144, 144, 3), None),
    "HunkyDisc": ({}, (1, 256, 256, 3), None),
    "HunkyNet": ({}, (1, 224, 224, 3), (2, 256, 256, 3)),
    "RedishCNN": (dict(n_channels=8, depth=30), (2, 112, 112, 3), None),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape, np.float32)


def _seeded(name, seed):
    """The port's ``name`` at the case's arguments, seeded; RedishCNN's
    shared BatchNorm calibrated to the cumulative mean of one train-mode
    forward's 48 uses."""
    model = fixtures.seed_zoo_module(build(name, **CASES[name][0]), seed)
    if name == "RedishCNN":
        model.bn.reset_running_stats()
        model.bn.momentum = None
        with torch.no_grad():
            model.train()(_nchw(_x((2, 112, 112, 3), 99)))
        model.bn.momentum = 0.1
    return model


@pytest.fixture(scope="module")
def trees():
    """Each name's (params, state) in JAX's layout, through ``params_io``."""
    return {name: params_io.relic_jax_from_state_dict(
        name, _seeded(name, 20 + i).state_dict()) for i, name in enumerate(NAMES)}


def _port(name, params, state):
    sd = params_io.relic_state_dict_from_jax(name, params, state)
    cls = get_network(name)
    model = cls(**cls.config_of(sd))
    model.load_state_dict(sd, strict=True)
    return model


_COMPILED = {}


def _jax_apply(name, train, **kw):
    """JAX's ``apply`` of ``name``, compiled once a class, mode and input
    shape (HulNet is Hul160Net) at ``FAST_COMPILE``."""
    cls = getattr(jax_relics, name)

    def run(p, x, s):
        key = (cls, train, tuple(sorted(kw.items())), np.shape(x))
        if key not in _COMPILED:
            _COMPILED[key] = jax.jit(lambda p, x, s: cls.apply(p, x, s, train=train, **kw)).lower(
                p, x, s).compile(FAST_COMPILE)
        return _COMPILED[key](p, x, s)
    return run


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_plan_tables_are_jax_s():
    assert relics._K == jax_relics._K
    assert relics.RRELU_EVAL_SLOPE == jax_relics.RRELU_EVAL_SLOPE == 55 / 240
    for name in NAMES[:-1]:
        assert get_network(name).plan == getattr(jax_relics, name).plan, name
    for c in ("in", 3, ("A", 7)):
        assert relics._resolve(c, 4, 6) == jax_relics._resolve(c, 4, 6)
    assert relics._dual("c3", "ab", 4, 2) == jax_relics._dual("c3", "ab", 4, 2)


def test_registry_resolves_the_relics():
    assert get_network("HulNet") is get_network("Hul160Net") is relics.Hul160Net
    assert jax_relics.HulNet is jax_relics.Hul160Net
    for name in NAMES:
        assert is_discriminator(name) == (getattr(jax_relics, name).kind == "discriminator")
    assert sorted(RELICS) == sorted(NAMES)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_forward_and_bn_state_match_jax(trees, name, train):
    _, eval_shape, train_shape = CASES[name]
    shape = train_shape if train and train_shape else eval_shape
    params, state = trees[name]
    x = _x(shape, 1)
    ref, ref_state = _jax_apply(name, train)(params, x, state)
    model = _port(name, params, state).train(train)
    with torch.no_grad():
        got = model(_nchw(x))
    atol = HUNKY_TRAIN_ATOL if (name, train) == ("HunkyNet", True) else ATOL
    assert got.shape == _nchw(np.asarray(ref)).shape
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=atol)
    _, got_state = params_io.relic_jax_from_state_dict(name, model.state_dict())
    # JAX's apply returns the state of the blocks it ran: Hul144Disc's
    # unused head (no BatchNorm) drops out of it
    extra = set(got_state) - set(ref_state)
    assert extra <= {"enc4to2pool"} and all(v is None for k in extra for v in got_state[k])
    assert jax.tree_util.tree_structure({k: got_state[k] for k in ref_state}) == \
        jax.tree_util.tree_structure(ref_state)
    ref_l, got_l = _leaves(ref_state), _leaves(got_state)
    for (path, r), (_, g) in zip(ref_l, got_l):
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=ATOL, err_msg=str(path))
    moved = any(not np.array_equal(g, s) for (_, g), s in
                zip(got_l, jax.tree_util.tree_leaves(state)))
    assert moved == (train and bool(ref_l))


def test_redishcnn_threads_its_shared_bn_and_find_noise(trees):
    """A train forward updates the shared BatchNorm at each of its
    2 * (depth - 6) uses in turn; the RReLU slope is fixed in train mode
    (two train forwards agree); ``find_noise`` returns x - out."""
    params, state = trees["RedishCNN"]
    model = _port("RedishCNN", params, state)
    x = _x((2, 112, 112, 3), 2)
    with torch.no_grad():
        a = model.train()(_nchw(x))
        b = model(_nchw(x))
    assert int(model.bn.num_batches_tracked) == 2 * (2 * (30 - 6))
    assert torch.equal(a, b)
    ref, _ = _jax_apply("RedishCNN", False, find_noise=True)(params, x, state)
    model = _port("RedishCNN", params, state).eval()
    model.find_noise = True
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(model(_nchw(x))), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("train", [False, True])
def test_hul144disc_finalpool_head(trees, train):
    """``finalpool``: the k3 sigmoid head under a global max-pool, on the
    same tree; the other head takes no part (no gradient reaches it)."""
    params, state = trees["Hul144Disc"]
    x = _x((2, 144, 144, 3), 3)
    ref, ref_state = _jax_apply("Hul144Disc", train, finalpool=True)(params, x, state)
    model = _port("Hul144Disc", params, state).train(train)
    model.finalpool = True
    xt = _nchw(x)
    got = model(xt)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)
    got.sum().backward()
    unused = ("enc4to2std", "decide")
    assert all(p.grad is None for n, p in model.named_parameters() if n.startswith(unused))
    assert all(p.grad is not None for n, p in model.named_parameters()
               if n.startswith("enc4to2pool"))
    _, got_state = params_io.relic_jax_from_state_dict("Hul144Disc", model.state_dict())
    for (path, r), (_, g) in zip(_leaves(ref_state), _leaves(got_state)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=ATOL, err_msg=str(path))


@pytest.mark.parametrize("name", ["HuDisc", "Hul144Disc", "HunkyDisc"])
def test_frozen_forward_is_jax_train_mode_and_changes_nothing(trees, name):
    """``frozen=True`` (the cGAN's ``pred_fn``): JAX's train-mode output in
    either mode, no buffer changed, no gradient to the module."""
    params, state = trees[name]
    x = _x(CASES[name][1], 4)
    ref, _ = _jax_apply(name, True)(params, x, state)
    model = _port(name, params, state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    xt = _nchw(x).requires_grad_()
    for mode in (True, False):
        got = model.train(mode)(xt, frozen=True)
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)
        got.sum().backward()
    assert xt.grad is not None and all(p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_mapping_is_exact_both_ways(trees, name):
    """The mapped tree has JAX's init layout (traced with
    ``jax.eval_shape``, nothing compiled): its structure, None entries
    included, and every leaf's path and shape; the mapping is exact both
    ways, from JAX's tree and from the port's own state_dict."""
    params, state = trees[name]
    layout = jax.eval_shape(lambda k: getattr(jax_relics, name).init(k, **CASES[name][0]),
                            jax.random.PRNGKey(0))
    for a, b in zip(layout, (params, state)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        assert [(p, tuple(x.shape)) for p, x in _leaves(a)] == [(p, x.shape) for p, x in _leaves(b)]
    sd = params_io.relic_state_dict_from_jax(name, params, state)
    back_p, back_s = params_io.relic_jax_from_state_dict(name, sd)
    for a, b in ((params, back_p), (state, back_s)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for (path, u), (_, v) in zip(_leaves(a), _leaves(b)):
            assert u.dtype == v.dtype and np.array_equal(u, v), path
    own = _port(name, params, state).state_dict()
    assert sorted(own) == sorted(sd)
    again = params_io.relic_state_dict_from_jax(name, *params_io.relic_jax_from_state_dict(
        name, own))
    for k in own:
        assert torch.equal(again[k], own[k]), k
    # parameters alone (an optimizer moment): no buffers, and no state where
    # the network has BatchNorm (JAX's all-None state where it has none)
    p_only = params_io.relic_state_dict_from_jax(name, params)
    assert sorted(p_only) == sorted(k for k, _ in _port(name, params, state).named_parameters())
    st = params_io.relic_jax_from_state_dict(name, p_only)[1]
    if _leaves(state):
        assert st is None
    else:
        assert jax.tree_util.tree_structure(st) == jax.tree_util.tree_structure(state)


# -- the cGAN ------------------------------------------------------------------------


@contextlib.contextmanager
def _threads(n):
    keep = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(keep)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads, as tests/test_torch_train_gan_cli.py pins its
    own: with one a core the six workers of the fast tier oversubscribe the
    box (the two-epoch run took 75x its serial time at the default); the
    step is read at eight, as tests/test_torch_gan.py reads its bounds
    (torch's CPU convolutions round by their thread count)."""
    with _threads(2):
        yield


def _batch(seed):
    rng = np.random.default_rng(seed)
    clean = gaussian_filter(rng.random((2, CS, CS, 3)), (0, 2, 2, 0)).astype(np.float32)
    clean = (clean - clean.min()) / np.ptp(clean)
    noisy = np.clip(clean + rng.normal(0, 0.08, clean.shape), 0, 1).astype(np.float32)
    return clean, noisy


def _crops(clean, noisy):
    c = lambda a: jax_steps.center_crop(jnp.asarray(a), LOSS_CS)  # noqa: E731
    generated = gaussian_filter(noisy, (0, 1, 1, 0)).astype(np.float32)
    return c(clean), c(generated), c(noisy)


def _jax_draws(key, shape):
    kr, kf = jax.random.split(key)
    return tuple(_nchw(jax.random.uniform(k, shape)) for k in (kr, kf))


def _amax(t):
    return float(t.abs().max()) if t.numel() else 0.0


def _sd(network, params, state=None):
    tree = jax.tree_util.tree_map(np.asarray, params)
    st = None if state is None else jax.tree_util.tree_map(np.asarray, state)
    return params_io.disc_state_dict_from_jax(network, tree, st)


def _grads(opt):
    """The summed gradients the step hands its optimizer, zeros where a
    parameter took none (the head Hul144Disc does not run), as the
    optimizer reads them."""
    return [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
            for p in opt.params]


def _gradient(port, batch, fake_is_noisy, draws, dtype):
    """The summed gradient of the port's step from its present state, on a
    copy in ``dtype``, float64, by parameter name."""
    c = disc_step_noise.copy_as(port, dtype)
    grads, opt_step = [], c.optimizer.step

    def spy():
        grads.extend(g.double() for g in _grads(c.optimizer))
        return opt_step()

    c.optimizer.step = spy
    c._step(*(t.to(dtype) for t in batch), fake_is_noisy,
            draws=tuple(t.to(dtype) for t in draws))
    return dict(zip([k for k, _ in port.model.named_parameters()], grads))


def _jax_step64(d, state, key, crops, fake_is_noisy, shape):
    """JAX's own step with x64 on, the params and inputs in float64, under
    an optimizer whose update is the gradient: (its gradient, new BN state,
    losses and ranges, its fuzzy targets' draws). JAX's BatchNorm casts to
    float32 whatever its input; here its ``jnp.float32`` names float64, so
    its own formula runs in float64. Compiled at ``FAST_COMPILE``."""
    ident = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                         lambda g, s, p=None: (g, s))
    step = jax_steps.make_discriminator_train_step(
        lambda p, s, x, train: d.net.apply(p, x, s, train=train), ident, conditional=True)
    wide = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("_")})
    wide.float32 = jnp.float64
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_norm, "jnp", wide)

        def f64(t):
            return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), t)

        params = f64(state.params)
        args = (jax_steps.TrainState(params, ident.init(params), f64(state.model_state)), key,
                *f64(list(crops)), jnp.asarray(fake_is_noisy))
        new, (loss_real, loss_fake, ranges) = step.lower(*args).compile(FAST_COMPILE)(*args)
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), new.params,
                                       params)
        draws = _jax_draws(key, shape)
    return grads, new.model_state, (float(loss_real), float(loss_fake), np.asarray(ranges)), draws


def _applied(params, updates):
    """``optax.apply_updates`` in numpy (float32 + float32, as optax adds
    them), without an eager compile per leaf shape."""
    return jax.tree_util.tree_map(lambda p, u: np.asarray(p) + np.asarray(u), params, updates)


def _jax_wrapper(network, **kw):
    """JAX's DiscriminatorWrapper (conditional, funit 2) with the port's
    seeded init as its fresh weights, in place of JAX's eager init."""
    fresh = params_io.disc_jax_from_state_dict(
        network, fixtures.seed_zoo_module(gan.init_disc(network, 6, 2, 0), 7).state_dict())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(getattr(jax_relics, network), "init", classmethod(lambda *a, **k: fresh))
        return jax_gan.DiscriminatorWrapper(ARGS, network=network, funit=2, lr=LR,
                                            conditional=True, patience=2, **kw)


@pytest.fixture(scope="module", params=["HuDisc", "Hul144Disc"])
def run(request, tmp_path_factory):
    """JAX's wrapper after one Adam step on a seeded gradient (optax,
    eager: JAX's own learn would cost a compile) and a mid-window
    scheduler, saved; the port resumed from that file; then one step of
    each from that common state on the same crops and targets (fake targets
    noisy): JAX's in float64, the port's in fp32 with its gradient
    captured, its gradient again in fp32 and float64 on copies, and
    optax's Adam applied to the port's gradient from the common state."""
    with _threads(8):
        return _run(request.param, tmp_path_factory.mktemp(request.param))


def _run(network, tmp):
    d = _jax_wrapper(network, seed=0)
    adam = jax.jit(d.optimizer.update)  # one compile a tree, not one an op
    rng = np.random.default_rng(8)
    g0 = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 1e-2).astype(np.float32),
                                d.state.params)
    updates, opt = adam(g0, d.state.opt_state, d.state.params)
    d.state = jax_steps.TrainState(_applied(d.state.params, updates), opt, d.state.model_state)
    d.update_learning_rate(1.0)
    d.update_learning_rate(1.0)  # num_bad 1: mid-window
    d.save_model(str(tmp), 3, "discriminator")
    port = gan.DiscriminatorWrapper(ARGS, network, funit=32, lr=LR, conditional=True, seed=9,
                                    patience=2, model_path=str(tmp / "discriminator_3.npz"),
                                    device="cpu")
    crops, key, s0 = _crops(*_batch(1)), jax.random.PRNGKey(11), d.state
    args = [_nchw(a) for a in crops]
    with torch.no_grad():
        b, _, h, w = port.model(torch.cat(args[2:] + args[1:2], 1), frozen=True).shape
    shape = (b, h, w, 1)
    g_jax, state64, out64, draws64 = _jax_step64(d, s0, key, crops, True, shape)
    g_port32 = _gradient(port, args, True, draws64, torch.float32)
    g_port64 = _gradient(port, args, True, draws64, torch.float64)
    grads, opt_step = [], port.optimizer.step

    def spy():
        grads.extend(_grads(port.optimizer))
        return opt_step()

    port.optimizer.step = spy
    got = port._step(*args, True, draws=tuple(t.float() for t in draws64))
    del port.optimizer.step
    names = [k for k, _ in port.model.named_parameters()]
    g_tree = params_io.disc_jax_from_state_dict(network, dict(zip(names, grads)))[0]
    updates, opt_ref = adam(g_tree, s0.opt_state, s0.params)
    return {"network": network, "jax": d, "port": port, "shape": shape, "state64": state64,
            "jax_out": out64, "port_out": tuple(t.numpy() for t in got),
            "grads": (_sd(network, g_jax), g_port32, g_port64),
            "adam_ref": (_applied(s0.params, updates), opt_ref.inner_state[0])}


def test_discriminator_step_matches_jax(run):
    (jl_r, jl_f, jr), (pl_r, pl_f, pr) = run["jax_out"], run["port_out"]
    assert abs(jl_r - float(pl_r)) <= TOL and abs(jl_f - float(pl_f)) <= TOL
    np.testing.assert_allclose(pr, jr, rtol=0, atol=TOL)
    d, port, network = run["jax"], run["port"], run["network"]
    assert port.optimizer.count == 2 and int(d.state.opt_state.count) == 1
    assert run["shape"][1:3] == ((2, 2) if network == "HuDisc" else (5, 5))
    # the BN running stats: the real side's update, then the fake side's
    got = port.model.state_dict()
    ref = _sd(network, d.state.params, run["state64"])
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            assert _amax(got[k] - ref[k]) <= TOL, k
    # the gradient: the port's float64 one against JAX's step run in float64
    # (a fault of semantics shows there), and the port's fp32 one against
    # its float64 one; where the float64 gradient is 0 (the head Hul144Disc
    # does not run) both packages give 0
    g_jax, g32, g64 = run["grads"]
    top = max(_amax(g) for g in g64.values())
    for k, g in g64.items():
        zero = g.abs() <= 1e-9 * top
        scale = _amax(g[~zero])
        assert _amax((g - g_jax[k])[~zero]) <= F64_TOL * scale, k
        assert _amax((g32[k] - g)[~zero]) <= GRAD_TOL * scale, k
        assert max(_amax(g32[k][zero]), _amax(g_jax[k][zero])) <= ZERO_TOL * top, k
        if k.startswith("enc4to2pool"):
            assert bool(zero.all()) and _amax(g32[k]) == _amax(g_jax[k]) == 0, k
    # the update: optax's Adam from the common state on the port's gradient
    params_ref, inner = run["adam_ref"]
    ck = port.checkpoint()
    mine = _sd(network, ck["params"])
    for k, v in _sd(network, params_ref).items():
        assert _amax(mine[k] - v) <= ADAM_TOL, k
    n = len(params_io.leaf_paths(ck["params"]))
    for j, ref in enumerate((inner.mu, inner.nu)):
        mine = _sd(network, params_io._unflatten_like(
            ck["params"], iter(ck["opt"][7 + j * n: 7 + (j + 1) * n])))
        for k, v in _sd(network, ref).items():
            assert _amax(mine[k] - v) <= 1e-6 * _amax(v), k


def test_port_checkpoint_resumes_in_the_jax_wrapper(run, tmp_path):
    """Every leaf, the unused head's Adam moments included, and the
    scheduler, leaf for leaf."""
    port, network = run["port"], run["network"]
    port.save_model(str(tmp_path), 5, "discriminator")
    j = _jax_wrapper(network, seed=5, model_path=str(tmp_path / "discriminator_5.npz"))
    assert (j.scheduler.lr, j.scheduler.best, j.scheduler.num_bad) == \
        (port.scheduler.lr, port.scheduler.best, port.scheduler.num_bad) == (LR, 1.0, 1)
    assert int(j.state.opt_state.count) == port.optimizer.count
    ck = port.checkpoint()
    got, ref = _sd(network, j.state.params, j.state.model_state), _sd(network, ck["params"],
                                                                      ck["state"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    inner = j.state.opt_state.inner_state[0]
    leaves = jax.tree_util.tree_leaves((inner.mu, inner.nu))
    assert len(leaves) == len(ck["opt"]) - 7
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(leaves, ck["opt"][7:]))


def test_a_pt_checkpoint_raises_as_in_jax(run, tmp_path):
    torch.save(run["port"].model.state_dict(), str(tmp_path / "discriminator_1.pt"))
    with pytest.raises(NotImplementedError, match=f"torch import for {run['network']}"):
        gan.DiscriminatorWrapper(ARGS, run["network"], 2, LR, True, seed=0,
                                 model_path=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match=f"torch import for {run['network']}"):
        _jax_wrapper(run["network"], seed=0, model_path=str(tmp_path))


@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    base = tmp_path_factory.mktemp("relic_cli")
    root = base / "SYN_192_184"
    rng = np.random.default_rng(6)
    for s in range(2):
        for x in (0, 192, 384):
            clean = gaussian_filter(rng.random((192, 192, 3)), (3, 3, 0))
            clean = (clean - clean.min()) / np.ptp(clean)
            for iso, sigma in (("ISO200", 0.0), ("ISO3200", 0.08)):
                d = root / f"scene{s}" / iso
                d.mkdir(parents=True, exist_ok=True)
                img = np.clip(clean + rng.normal(0, sigma, clean.shape), 0, 1)
                cv2.imwrite(str(d / f"SYN_scene{s}_{iso}_{x}_0_192.png"),
                            (img * 65535).astype(np.uint16))
    d = root / "scene0"
    vy = base / "val.yaml"
    vy.write_text(yaml.safe_dump([[str(d / "ISO200" / "SYN_scene0_ISO200_0_0_192.png"),
                                   str(d / "ISO3200" / "SYN_scene0_ISO3200_0_0_192.png")]]))
    init = str(base / "init.npz")
    fixtures.write_jax_checkpoint(init, 8, 0)
    return ["--train_data", str(root), "--test_reserve", "0", "--g_network", "UtNet",
            "--g_funit", "8", "--g_model_path", init, "--cs", "184", "--loss_cs", "184",
            "--batch_size", "2", "--g_lr", "3e-4", "--weight_MSSSIM", "0", "--weight_MSE", "1",
            "--validation_set_yaml", str(vy), "--threads", "1", "--device", "cpu",
            "--d_funit", "2", "--d2_funit", "2"]


def test_two_epoch_cgan_run_with_hudisc_and_hul144disc(crops, tmp_path):
    """``train.loop`` with HuDisc as D1 and Hul144Disc as D2 at loss_cs
    184: both learn, their terms reach the generator's loss, each
    checkpoints in JAX's layout (Hul144Disc with both heads), and a resume
    from both carries Adam's counts; HunkyDisc is refused there before
    anything is written."""
    argv = crops + ["--weight_D1", "0.2", "--d_lr", "1e-4", "--d_network", "HuDisc",
                    "--weight_D2", "0.2", "--d2_lr", "1e-4", "--d2_network", "Hul144Disc"]
    exp = loop.main(argv + ["--epochs", "3", "--models_dpath", str(tmp_path / "a")])
    with open(os.path.join(exp, "train.log")) as f:
        lines = [ln for ln in f.read().splitlines() if re.match(r"Epoch \d+ batch \d+/", ln)]
    assert len(lines) == 6
    learns = {w: sum(f"loss {w}: " in ln for ln in lines) for w in ("D1", "D2")}
    assert all(learns.values())
    g_lines = [ln.split("loss G: ")[1] for ln in lines if "loss G: " in ln]
    assert g_lines and all("D1: " in g and "D2: " in g for g in g_lines)
    for name, net in (("discriminator", "HuDisc"), ("discriminator2", "Hul144Disc")):
        tree = params_io.load_npz(os.path.join(exp, f"{name}_2.npz"))
        assert int(tree["opt"][0]) == learns["D1" if name == "discriminator" else "D2"]
        layout = jax.eval_shape(lambda k: getattr(jax_relics, net).init(
            k, input_channels=6, funit=2), jax.random.PRNGKey(0))
        for a, b in zip(layout, (tree["params"], tree["state"])):
            assert [(p, tuple(x.shape)) for p, x in _leaves(a)] == \
                [(p, x.shape) for p, x in _leaves(b)]
    again = loop.main(argv + [
        "--epochs", "4", "--g_model_path", os.path.join(exp, "generator_2.npz"),
        "--d_model_path", os.path.join(exp, "discriminator_2.npz"),
        "--d2_model_path", os.path.join(exp, "discriminator2_2.npz"),
        "--models_dpath", str(tmp_path / "b")])
    with open(os.path.join(again, "train.log")) as f:
        log = f.read()
    assert "Resuming at epoch 3" in log
    d3 = params_io.load_npz(os.path.join(again, "discriminator2_3.npz"))
    more = sum("loss D2: " in ln for ln in log.splitlines() if ln.startswith("Epoch 3 batch"))
    assert int(d3["opt"][0]) == learns["D2"] + more
    with pytest.raises(ValueError, match="prediction map is empty"):
        loop.main(crops + ["--weight_D1", "0.2", "--d_lr", "1e-4", "--d_network", "HunkyDisc",
                           "--models_dpath", str(tmp_path / "c")])
    assert not os.path.exists(tmp_path / "c")


@pytest.mark.parametrize("network", ["HunNet", "RedishCNN", "MobileNetV3",
                                     "deeplabv3_resnet101"])
def test_the_trainer_refuses_the_registry_only_generators(crops, tmp_path, network):
    """As JAX's trainer: the relic generators, MobileNetV3 and the deeplab
    stub are registry / inference networks, refused before anything is
    written."""
    with pytest.raises(SystemExit, match="registry/inference-only"):
        loop.main(crops + ["--g_network", network, "--models_dpath", str(tmp_path / "m")])
    assert not os.path.exists(tmp_path / "m")
