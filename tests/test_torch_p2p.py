"""The port's pix2pix networks (``models/p2p.py``) against the JAX
package's on the CPU, and the PatchGAN and pixel discriminators in the
port's cGAN against JAX's discriminator wrapper.

Forwards: ngf 8 / 2 blocks (ResnetGenerator, 64 px), ndf 8 with 3 layers
(PatchGAN, 64 px), ndf 8 (PixelDiscriminator, 40 px) and num_D 3 at ndf 4
(MultiscaleDiscriminator, 64 px), weights and every BatchNorm's scale,
bias and stats drawn from a numpy seed, in JAX's layout (held to JAX's
init) through ``params_io``; numpy-seeded inputs. Eval and train mode,
the new running stats, instance norm, the sigmoid, the frozen forward;
the state_dict mapping both ways; ``define_G`` and ``define_D``.

The cGAN: the JAX wrapper with ``--d_network PatchGAN`` or
``PixelDiscriminator`` builds the net at its defaults, 6 channels and ndf
64, whatever funit it is given, and so does the port's (JAX's fresh
weights are the port's seeded init, in place of its eager init). JAX
takes four learns on seeded 2 x 120 px batches (112 px crops), moves its
plateau scheduler mid-window and saves ``discriminator_3.npz``; the port
resumes from that file, and both take one step from that common state with
JAX's fuzzy targets; JAX then resumes the port's checkpoint and both take
one ``learn``. A port checkpoint resumes in JAX's wrapper exactly; a
two-epoch ``train.loop`` runs with PatchGAN as D1 and the pixel critic as
D2 and resumes.

Tolerances, float32: forwards and BN stats 5e-5 absolute (seen ~1e-6);
the mapping bit-exact. The ndf-64 step, from the common state: losses,
prediction ranges and the BN running stats 1e-5 absolute (seen 1.6e-6 on
a loss; torch on eight threads, as tests/test_torch_gan.py reads its
bounds). Its gradient is held, not the parameters after Adam: XLA's fp32
gradient on the CPU lies up to 3 % of a tensor's largest entry from
float64 (seen: PatchGAN's last ladder conv), and Adam turns that into up
to a quarter of the learning rate on small elements. So the port's
float64 gradient is held to JAX's own step run in float64 within 1e-6 of
each tensor's largest entry (seen 5e-8), and the port's fp32 gradient to
its float64 one within 1e-3 (seen 1.2e-4: the pixel critic's BatchNorm
over 25k elements cancels); elements that are 0 in float64 (the biases a
BatchNorm cancels) are rounding noise below 1e-5 of the largest gradient
in both packages (seen 1.4e-6). The update is optax's Adam from the
common state on the port's own gradient, within 2.5e-7 absolute (fp32
ulps below 2), its moments within 1e-6 relative.
"""

import os
import re
import types

import numpy as np
import pytest
import torch
import yaml
from scipy.ndimage import gaussian_filter

import cv2
import jax
import jax.numpy as jnp
import optax

from nind_denoise_tpu.models import norm as jax_norm
from nind_denoise_tpu.models import p2p as jax_p2p
from nind_denoise_tpu.train import gan as jax_gan
from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.models import ZOO, build, get_network, p2p, params_io
from nind_denoise_tpu_torch.tools import disc_step_noise, fixtures
from nind_denoise_tpu_torch.train import gan, loop

ATOL = 5e-5
TOL = 1e-5
F64_TOL, GRAD_TOL, ZERO_TOL, ADAM_TOL = 1e-6, 1e-3, 1e-5, 2.5e-7
LR = 1e-4
ARGS = types.SimpleNamespace(beta1=0.5, models_dpath=None)
CS, LOSS_CS = 120, 112
WARM = 4  # JAX learns before the checkpoint the port resumes


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape, np.float32)


# (network, JAX class, init kwargs, apply kwargs, input NHWC)
CASES = {
    "resnet_batch": ("ResnetGenerator", jax_p2p.ResnetGenerator, dict(ngf=8, n_blocks=2),
                     {}, (2, 64, 64, 3)),
    "resnet_instance": ("ResnetGenerator", jax_p2p.ResnetGenerator,
                        dict(ngf=8, n_blocks=2, norm_type="instance"),
                        dict(norm_type="instance"), (2, 64, 64, 3)),
    "patchgan_batch": ("PatchGAN", jax_p2p.NLayerDiscriminator, dict(ndf=8, n_layers=3),
                       {}, (2, 64, 64, 6)),
    "patchgan_instance_sigmoid": ("NLayerDiscriminator", jax_p2p.NLayerDiscriminator,
                                  dict(ndf=8, n_layers=2, norm_type="instance"),
                                  dict(norm_type="instance", use_sigmoid=True), (2, 64, 64, 6)),
    "pixel_batch": ("PixelDiscriminator", jax_p2p.PixelDiscriminator, dict(ndf=8), {},
                    (2, 40, 40, 6)),
    "multiscale_batch": ("MultiscaleDiscriminator", jax_p2p.MultiscaleDiscriminator,
                         dict(ndf=4, num_D=3), {}, (2, 64, 64, 6)),
}


@pytest.fixture(scope="module")
def trees():
    """Each case's weights in JAX's layout: the port's module at the JAX
    init's arguments, seeded (``fixtures.seed_zoo_module``: every
    BatchNorm's scale, bias and stats drawn too), through ``params_io``.
    JAX's eager init would cost ~25 s of compiles here; its layout is held
    by ``test_state_dict_mapping_is_exact_both_ways``."""
    out = {}
    for i, (case, (network, _, init_kw, _, _)) in enumerate(CASES.items()):
        model = fixtures.seed_zoo_module(build(network, **init_kw), 10 + i)
        out[case] = params_io.zoo_jax_from_state_dict(network, model.state_dict())
    return out


def _port(case, params, state):
    network, _, _, apply_kw, _ = CASES[case]
    sd = params_io.zoo_state_dict_from_jax(network, params, state)
    cfg = ZOO[network].config_of(sd)
    if apply_kw.get("use_sigmoid"):
        cfg["use_sigmoid"] = True
    model = ZOO[network](**cfg)
    model.load_state_dict(sd, strict=True)
    return model


def _outs(y):
    return [np.asarray(t) for t in y] if isinstance(y, (list, tuple)) else [np.asarray(y)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_bn_state_match_jax(trees, case, train):
    network, cls, _, apply_kw, shape = CASES[case]
    params, state = trees[case]
    x = _x(shape, 1)
    ref, ref_state = jax.jit(lambda p, x, s: cls.apply(p, x, s, train=train, **apply_kw))(
        params, x, state)
    model = _port(case, params, state).train(train)
    with torch.no_grad():
        got = model(_nchw(x))
    got = [_nhwc(t) for t in got] if isinstance(got, list) else [_nhwc(got)]
    ref = _outs(ref)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)
    _, got_state = params_io.zoo_jax_from_state_dict(network, model.state_dict())
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_state)
    got_leaves = jax.tree_util.tree_leaves_with_path(got_state)
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (path, r), (_, g) in zip(ref_leaves, got_leaves):
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=ATOL, err_msg=str(path))
    moved = any(not np.array_equal(g, s) for (_, g), s in
                zip(got_leaves, jax.tree_util.tree_leaves(state)))
    assert moved == (train and bool(ref_leaves))


@pytest.mark.parametrize("case", ["patchgan_batch", "pixel_batch", "multiscale_batch"])
def test_frozen_forward_is_jax_train_mode_and_changes_nothing(trees, case):
    """``frozen=True`` (the cGAN's ``pred_fn``): JAX's train-mode output in
    either mode, no buffer changed, no gradient to the module."""
    network, cls, _, apply_kw, shape = CASES[case]
    params, state = trees[case]
    x = _x(shape, 2)
    ref, _ = cls.apply(params, jnp.asarray(x), state, train=True, **apply_kw)
    model = _port(case, params, state)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    xt = _nchw(x).requires_grad_()
    for mode in (True, False):
        got = model.train(mode)(xt, frozen=True)
        got = got if isinstance(got, list) else [got]
        for g, r in zip(got, _outs(ref)):
            np.testing.assert_allclose(_nhwc(g), r, rtol=0, atol=ATOL)
        sum(g.sum() for g in got).backward()
    assert xt.grad is not None and all(p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_mapping_is_exact_both_ways(trees, case):
    """The mapped tree has JAX's init layout, key for key and shape for
    shape (traced with ``jax.eval_shape``, nothing compiled), and the
    mapping is exact both ways."""
    network, cls, init_kw, _, _ = CASES[case]
    params, state = trees[case]
    layout = jax.eval_shape(lambda k: cls.init(k, **init_kw), jax.random.PRNGKey(0))
    for a, b in zip(layout, (params, state)):
        ra, rb = (jax.tree_util.tree_leaves_with_path(t) for t in (a, b))
        assert [(p, tuple(x.shape)) for p, x in ra] == [(p, x.shape) for p, x in rb]
    sd = params_io.zoo_state_dict_from_jax(network, params, state)
    back_p, back_s = params_io.zoo_jax_from_state_dict(network, sd)
    for a, b in ((params, back_p), (state, back_s)):
        ra, rb = (jax.tree_util.tree_leaves_with_path(t) for t in (a, b))
        assert [p for p, _ in ra] == [p for p, _ in rb]
        for (path, u), (_, v) in zip(ra, rb):
            assert u.dtype == v.dtype and np.array_equal(u, v), path
    model = _port(case, params, state)
    own = model.state_dict()
    again = params_io.zoo_state_dict_from_jax(network, *params_io.zoo_jax_from_state_dict(
        network, own))
    assert sorted(again) == sorted(own)
    for k in own:
        assert torch.equal(again[k], own[k]), k


def _layout(tree):
    return [(p, tuple(x.shape)) for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _traced(factory):
    """(the class, the layout of the (params, state) it inits) of a JAX
    factory, traced with ``jax.eval_shape``: nothing compiled."""
    box = {}

    def init(key):
        box["net"], tree = factory(key)
        return tree

    layout = _layout(jax.eval_shape(init, jax.random.PRNGKey(0)))
    return box["net"], layout


@pytest.mark.parametrize("args,kw,cls", [
    (("Resnet",), dict(n_blocks=2), "ResnetGenerator"),
    (("Resnet",), dict(n_blocks=1, norm="instance"), "ResnetGenerator"),
])
def test_define_g_matches_jax(args, kw, cls):
    """The same network as JAX's factory builds (its layout traced), with
    the same forward on seeded weights."""
    norm = kw.pop("norm", "batch")
    net, layout = _traced(lambda k: jax_p2p.define_G(k, 3, 3, 8, norm, *args, **kw))
    model = fixtures.seed_zoo_module(p2p.define_G(3, 3, 8, norm, *args, **kw), 3).eval()
    assert type(model).__name__ == cls == net.name
    params, state = params_io.zoo_jax_from_state_dict(cls, model.state_dict())
    assert _layout((params, state)) == layout
    x = _x((1, 32, 32, 3), 4)
    ref, _ = net.apply(params, jnp.asarray(x), state, train=False, norm_type=norm)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(model(_nchw(x))), np.asarray(ref), rtol=0, atol=ATOL)
    # any other net_type is the registry's, built from its own arguments
    assert type(p2p.define_G(3, 3, 8, net_type="UtNet", funit=4)).__name__ == "UtNet"


@pytest.mark.parametrize("netD,n_layers,cls", [
    ("basic", 3, "NLayerDiscriminator"), ("n_layers", 2, "NLayerDiscriminator"),
    ("pixel", 3, "PixelDiscriminator"), ("multiscale", 2, "MultiscaleDiscriminator"),
])
def test_define_d_matches_jax(netD, n_layers, cls):
    net, layout = _traced(lambda k: jax_p2p.define_D(k, 6, 4, netD, n_layers))
    model = fixtures.seed_zoo_module(p2p.define_D(6, 4, netD, n_layers), 5).eval()
    assert type(model).__name__ == cls == net.name
    params, state = params_io.zoo_jax_from_state_dict(cls, model.state_dict())
    assert _layout((params, state)) == layout
    x = _x((1, 64, 64, 6), 6)
    ref, _ = net.apply(params, jnp.asarray(x), state, train=False)
    with torch.no_grad():
        got = model(_nchw(x))
    for g, r in zip(got if isinstance(got, list) else [got], _outs(ref)):
        np.testing.assert_allclose(_nhwc(g), r, rtol=0, atol=ATOL)
    # a registry discriminator takes input_channels and its own arguments
    hul = p2p.define_D(6, 4, "Hul112Disc", funit=1)
    assert type(hul).__name__ == "HulDisc" and hul.shape_of(hul.state_dict()) == (6, 1)


def test_registry_builds_the_zoo_and_drops_what_it_does_not_take():
    """``build`` drops arguments a constructor does not take, as JAX's
    ``init(**_ignored)`` does: the cGAN's critics stay 6-channel at ndf 64."""
    m = build("PatchGAN", input_channels=3, funit=32)
    assert m.config_of(m.state_dict()) == {"input_nc": 6, "ndf": 64, "n_layers": 3,
                                           "norm_type": "batch"}
    assert get_network("PatchGAN") is get_network("NLayerDiscriminator") is p2p.NLayerDiscriminator
    assert build("DnCNN", depth=4, n_channels=8).config_of(
        build("DnCNN", depth=4, n_channels=8).state_dict())["depth"] == 4


# -- the cGAN ------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def eight_threads():
    """torch's CPU convolutions round by their thread count: the step
    tolerances were read at 8, as tests/test_torch_gan.py reads its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    rng = np.random.default_rng(seed)
    clean = gaussian_filter(rng.random((2, CS, CS, 3)), (0, 2, 2, 0)).astype(np.float32)
    clean = (clean - clean.min()) / np.ptp(clean)
    noisy = np.clip(clean + rng.normal(0, 0.08, clean.shape), 0, 1).astype(np.float32)
    generated = gaussian_filter(noisy, (0, 1, 1, 0)).astype(np.float32)
    return clean, noisy, generated


def _crops(clean, noisy, generated):
    c = lambda a: jax_steps.center_crop(jnp.asarray(a), LOSS_CS)  # noqa: E731
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


def _gradient(port, batch, fake_is_noisy, draws, dtype):
    """The summed gradient of the port's step from its present state, on a
    copy in ``dtype``, float64, by parameter name."""
    c = disc_step_noise.copy_as(port, dtype)
    grads, opt_step = [], c.optimizer.step

    def spy():
        grads.extend(p.grad.detach().double().clone() for p in c.optimizer.params)
        return opt_step()

    c.optimizer.step = spy
    c._step(*(t.to(dtype) for t in batch), fake_is_noisy,
            draws=tuple(t.to(dtype) for t in draws))
    return dict(zip([k for k, _ in port.model.named_parameters()], grads))


def _jax_gradient(d, state, key, crops, fake_is_noisy, shape):
    """JAX's own step (``make_discriminator_train_step``) with x64 on, the
    params and inputs in float64, under an optimizer whose update is the
    gradient; and its fuzzy targets' draws (predictions of ``shape``).
    JAX's BatchNorm (``models/norm.py``) casts to float32 whatever its
    input; here its ``jnp.float32`` names float64, so its own formula runs
    in float64."""
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

        params, crops64 = f64(state.params), f64(list(crops))
        new, _ = step(jax_steps.TrainState(params, ident.init(params), f64(state.model_state)),
                      key, *crops64, jnp.asarray(fake_is_noisy))
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), new.params, params)
        draws = _jax_draws(key, shape)
    return grads, draws


def _jax_wrapper(network, **kw):
    """JAX's DiscriminatorWrapper (conditional, funit 1, which the pix2pix
    critics ignore) with the port's seeded init as its fresh weights, in
    place of JAX's eager init (~3 s of compiles at ndf 64)."""
    fresh = params_io.disc_jax_from_state_dict(
        network, gan.init_disc(network, 6, 1, 0).state_dict())
    net = getattr(jax_p2p, "NLayerDiscriminator" if network == "PatchGAN" else network)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(net, "init", staticmethod(lambda *a, **k: fresh))
        return jax_gan.DiscriminatorWrapper(ARGS, network=network, funit=1, lr=LR,
                                            conditional=True, patience=2, **kw)


@pytest.fixture(scope="module", params=["PatchGAN", "PixelDiscriminator"])
def run(request, tmp_path_factory):
    """JAX's wrapper after WARM learns and a mid-window scheduler, saved;
    the port resumed from that file; then one step of each from that common
    state on the same crops and targets (fake targets noisy), with the
    port's gradient captured, JAX's gradient taken in float64 and optax's
    Adam applied to the port's gradient from the common state."""
    network = request.param
    tmp = tmp_path_factory.mktemp(network)
    d = _jax_wrapper(network, seed=0)
    jgen = types.SimpleNamespace(state=types.SimpleNamespace(params={}),
                                 apply_fn=lambda p, x: x)
    for k in range(WARM):
        clean, noisy, _ = _batch(100 + k)
        d.learn(jax.random.PRNGKey(k), clean, noisy, jgen, loss_cs=LOSS_CS)
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
    g_jax, draws64 = _jax_gradient(d, s0, key, crops, True, shape)
    d.state, (lr_, lf_, ranges) = d._step(s0, key, *crops, jnp.asarray(True))
    g_port32 = _gradient(port, args, True, draws64, torch.float32)
    g_port64 = _gradient(port, args, True, draws64, torch.float64)
    grads, opt_step = [], port.optimizer.step

    def spy():
        grads.extend(p.grad.detach().clone() for p in port.optimizer.params)
        return opt_step()

    port.optimizer.step = spy
    got = port._step(*args, True, draws=_jax_draws(key, shape))
    del port.optimizer.step
    names = [k for k, _ in port.model.named_parameters()]
    g_tree = params_io.disc_jax_from_state_dict(network, dict(zip(names, grads)))[0]
    updates, opt_ref = d.optimizer.update(g_tree, s0.opt_state, s0.params)
    return {"network": network, "jax": d, "port": port, "jgen": jgen, "shape": shape,
            "jax_out": (float(lr_), float(lf_), np.asarray(ranges)),
            "port_out": tuple(t.numpy() for t in got),
            "grads": (_sd(network, g_jax), g_port32, g_port64),
            "adam_ref": (optax.apply_updates(s0.params, updates), opt_ref.inner_state[0])}


def test_the_critic_is_6_channel_at_ndf_64_in_both(run):
    cfg = ZOO[run["network"]].config_of(run["port"].model.state_dict())
    assert cfg["input_nc"] == 6 and cfg["ndf"] == 64
    w = (run["jax"].state.params["layers"][0]["c"]["w"] if run["network"] == "PatchGAN"
         else run["jax"].state.params["c0"]["w"])
    assert w.shape[-2:] == (6, 64)


def test_discriminator_step_matches_jax(run):
    (jl_r, jl_f, jr), (pl_r, pl_f, pr) = run["jax_out"], run["port_out"]
    assert abs(jl_r - float(pl_r)) <= TOL and abs(jl_f - float(pl_f)) <= TOL
    np.testing.assert_allclose(pr, jr, rtol=0, atol=TOL)
    d, port, network = run["jax"], run["port"], run["network"]
    assert port.optimizer.count == WARM + 1 == int(d.state.opt_state.count)
    # the BN running stats: the real side's update, then the fake side's
    got = port.model.state_dict()
    ref = _sd(network, d.state.params, d.state.model_state)
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            assert _amax(got[k] - ref[k]) <= TOL, k
    # the gradient: the port's float64 one against JAX's step run in float64
    # (a fault of semantics shows there), and the port's fp32 one against
    # its float64 one; where the float64 gradient is 0 (a cancelled bias)
    # both packages give rounding noise
    g_jax, g32, g64 = run["grads"]
    top = max(_amax(g) for g in g64.values())
    for k, g in g64.items():
        zero = g.abs() <= 1e-9 * top
        scale = _amax(g[~zero])
        assert _amax((g - g_jax[k])[~zero]) <= F64_TOL * scale, k
        assert _amax((g32[k] - g)[~zero]) <= GRAD_TOL * scale, k
        assert max(_amax(g32[k][zero]), _amax(g_jax[k][zero])) <= ZERO_TOL * top, k
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


def test_learn_matches_jax(run, tmp_path):
    """``learn`` from a common state (JAX resumes the port's checkpoint):
    the generator forward, clip, crops, the noisy-target switch from the
    previous loss, the scalar loss and the ranges' text."""
    port, network = run["port"], run["network"]
    port.save_model(str(tmp_path), 4, "discriminator")
    d = _jax_wrapper(network, seed=5, model_path=str(tmp_path / "discriminator_4.npz"))
    clean, noisy, _ = _batch(3)
    d.loss = port.loss = 0.2  # fake targets noisy
    key = jax.random.PRNGKey(21)
    d.learn(key, clean, noisy, run["jgen"], loss_cs=LOSS_CS)
    port.learn(_nchw(clean), _nchw(noisy), types.SimpleNamespace(infer=lambda x: x), LOSS_CS,
               draws=_jax_draws(key, run["shape"]))
    assert abs(port.loss - d.loss) <= TOL
    assert port.predictions_range == d.predictions_range
    assert port.optimizer.count == int(d.state.opt_state.count) == WARM + 2


def test_port_checkpoint_resumes_in_the_jax_wrapper(run, tmp_path):
    port, network = run["port"], run["network"]
    port.save_model(str(tmp_path), 5, "discriminator")
    j = _jax_wrapper(network, seed=5, model_path=str(tmp_path / "discriminator_5.npz"))
    assert (j.scheduler.lr, j.scheduler.best, j.scheduler.num_bad) == \
        (port.scheduler.lr, port.scheduler.best, port.scheduler.num_bad) == (LR, 1.0, 1)
    assert int(j.state.opt_state.count) == port.optimizer.count
    assert jax_steps.get_lr(j.state) == port.optimizer.hyper["learning_rate"]
    ck = port.checkpoint()
    got, ref = _sd(network, j.state.params, j.state.model_state), _sd(network, ck["params"],
                                                                      ck["state"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    inner = j.state.opt_state.inner_state[0]
    leaves = jax.tree_util.tree_leaves((inner.mu, inner.nu))
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(leaves, ck["opt"][7:]))


def test_a_pt_checkpoint_raises_as_in_jax(run, tmp_path):
    torch.save(run["port"].model.state_dict(), str(tmp_path / "discriminator_1.pt"))
    with pytest.raises(NotImplementedError, match=f"torch import for {run['network']}"):
        gan.DiscriminatorWrapper(ARGS, run["network"], 1, LR, True, seed=0,
                                 model_path=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match=f"torch import for {run['network']}"):
        _jax_wrapper(run["network"], seed=0, model_path=str(tmp_path))


@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    base = tmp_path_factory.mktemp("p2p_cli")
    root = base / "SYN_192_176"
    rng = np.random.default_rng(5)
    for s in range(2):
        for x in (0, 176, 352):
            clean = gaussian_filter(rng.random((192, 192, 3)), (3, 3, 0))
            clean = (clean - clean.min()) / np.ptp(clean)
            for iso, sigma in (("ISO200", 0.0), ("ISO3200", 0.08)):
                d = root / f"scene{s}" / iso
                d.mkdir(parents=True, exist_ok=True)
                img = np.clip(clean + rng.normal(0, sigma, clean.shape), 0, 1)
                cv2.imwrite(str(d / f"SYN_scene{s}_{iso}_{x}_0_176.png"),
                            (img * 65535).astype(np.uint16))
    d = root / "scene0"
    vy = base / "val.yaml"
    vy.write_text(yaml.safe_dump([[str(d / "ISO200" / "SYN_scene0_ISO200_0_0_176.png"),
                                   str(d / "ISO3200" / "SYN_scene0_ISO3200_0_0_176.png")]]))
    init = str(base / "init.npz")
    fixtures.write_jax_checkpoint(init, 4, 0)
    return ["--train_data", str(root), "--test_reserve", "0", "--g_network", "UtNet",
            "--g_funit", "4", "--g_model_path", init, "--cs", "168", "--loss_cs", "168",
            "--batch_size", "2", "--g_lr", "3e-4", "--weight_MSSSIM", "0", "--weight_MSE", "1",
            "--validation_set_yaml", str(vy), "--threads", "1", "--device", "cpu"]


def test_two_epoch_cgan_run_with_patchgan_and_the_pixel_critic(crops, tmp_path):
    """``train.loop`` with PatchGAN as D1 and PixelDiscriminator as D2: both
    learn, their terms reach the generator's loss, each checkpoints in
    JAX's layout, and a resume from both carries Adam's counts."""
    argv = crops + ["--weight_D1", "0.2", "--d_lr", "1e-4", "--d_network", "PatchGAN",
                    "--weight_D2", "0.2", "--d2_lr", "1e-4", "--d2_network",
                    "PixelDiscriminator"]
    exp = loop.main(argv + ["--epochs", "3", "--models_dpath", str(tmp_path / "a")])
    with open(os.path.join(exp, "train.log")) as f:
        lines = [ln for ln in f.read().splitlines() if re.match(r"Epoch \d+ batch \d+/", ln)]
    assert len(lines) == 6
    learns = {w: sum(f"loss {w}: " in ln for ln in lines) for w in ("D1", "D2")}
    assert all(learns.values())
    g_lines = [ln.split("loss G: ")[1] for ln in lines if "loss G: " in ln]
    assert g_lines and all("D1: " in g and "D2: " in g for g in g_lines)
    for name, net in (("discriminator", "PatchGAN"), ("discriminator2", "PixelDiscriminator")):
        tree = params_io.load_npz(os.path.join(exp, f"{name}_2.npz"))
        assert int(tree["opt"][0]) == learns["D1" if name == "discriminator" else "D2"]
        assert ZOO[net].config_of(_sd(net, tree["params"], tree["state"]))["ndf"] == 64
    again = loop.main(argv + [
        "--epochs", "4", "--g_model_path", os.path.join(exp, "generator_2.npz"),
        "--d_model_path", os.path.join(exp, "discriminator_2.npz"),
        "--d2_model_path", os.path.join(exp, "discriminator2_2.npz"),
        "--models_dpath", str(tmp_path / "b")])
    with open(os.path.join(again, "train.log")) as f:
        log = f.read()
    assert "Resuming at epoch 3" in log
    d3 = params_io.load_npz(os.path.join(again, "discriminator_3.npz"))
    more = sum("loss D1: " in ln for ln in log.splitlines() if ln.startswith("Epoch 3 batch"))
    assert int(d3["opt"][0]) == learns["D1"] + more
