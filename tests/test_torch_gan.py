"""The port's cGAN pieces (``train/gan.py`` and the discriminator half of
``train/steps.py``) against the JAX trainer's, on the CPU.

A conditional Hul112Disc at funit 1 on seeded 2 x 120 px batches cropped
to 112 px. The JAX wrapper takes eight steps (a young Adam state moves
an element whose gradient is fp32 rounding noise by up to the learning
rate, so the two packages' gradient rounding would decide the step),
moves its plateau scheduler mid-window and saves ``discriminator_3.npz``;
the port resumes
from that file and both take the same further steps with JAX's fuzzy
targets injected. The JAX wrapper's fresh weights are the port's seeded
torch init, handed to it in place of ``Hul112Disc.init`` (whose eager
JAX init costs 17 s of the CPU). A generator step with the D1 term runs a one-conv
generator (the term does not depend on the generator's architecture)
against ``make_generator_train_step(disc_apply_fns=...)``.

Tolerances, float32: losses, prediction ranges, parameters and BN
running stats 1e-6 absolute; Adam's moments 1e-3 of each tensor's
largest entry (seen: 1.6e-4, a PReLU slope's summed gradient); the
discriminator bit-unchanged by a generator step.
"""

import types

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax
import jax.numpy as jnp
from jax import lax

from nind_denoise_tpu.models import hul as jax_hul
from nind_denoise_tpu.train import gan as jax_gan
from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.train import gan, steps

ARGS = types.SimpleNamespace(beta1=0.5, models_dpath=None)
CS, LOSS_CS, TOL = 120, 112, 1e-6
WARM = 8  # JAX discriminator steps before the checkpoint the port resumes
DF = 1  # the discriminator's funit


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


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
    """The uniform draws inside JAX's step for ``key``, real side first."""
    kr, kf = jax.random.split(key)
    return tuple(_nchw(jax.random.uniform(k, shape)) for k in (kr, kf))


def _sd(params, state=None):
    """A JAX Hul tree as the port's state_dict: the comparison ignores the
    PReLU weight that JAX's init gives the decide head's last conv, which
    has no activation (never used, never saved by ``export_hul_disc``)."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    st = None if state is None else jax.tree_util.tree_map(np.asarray, state)
    return params_io.hul_state_dict_from_jax(tree, st, "Hul112Disc")


def _close(a, b, atol=TOL, rtol=0.0):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=rtol, atol=atol, err_msg=k)


def _port_moments(ck):
    """mu and nu trees of a port checkpoint's Adam leaves."""
    n = len(params_io.leaf_paths(ck["params"]))
    return [params_io._unflatten_like(ck["params"], iter(ck["opt"][7 + j * n: 7 + (j + 1) * n]))
            for j in range(2)]


def _jax_opt_moments(opt_state):
    inner = opt_state.inner_state[0]
    return inner.mu, inner.nu


def _identity_gen():
    return types.SimpleNamespace(infer=lambda x: x)


def _jax_wrapper(**kw):
    """JAX's DiscriminatorWrapper (Hul112Disc, funit 1, conditional) with
    the port's seeded init as its fresh weights."""
    def init(key, input_channels=3, funit=32, **_):
        return params_io.hul_jax_from_state_dict(
            gan.init_disc("Hul112Disc", input_channels, funit, 0).state_dict(), "Hul112Disc")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hul.Hul112Disc, "init", classmethod(lambda cls, *a, **k: init(*a, **k)))
        return jax_gan.DiscriminatorWrapper(ARGS, network="Hul112Disc", funit=DF, lr=1e-4,
                                            conditional=True, patience=2, **kw)


@pytest.fixture(scope="module", autouse=True)
def eight_threads():
    """torch's CPU convolutions round by their thread count: the
    tolerances above were read at 8 (seen at 1 thread: predictions 2e-6
    from JAX's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX wrapper after one learn and a mid-window scheduler, saved;
    the port resumed from that file; then two steps of each on the same
    crops and targets (fake targets clean, then noisy), and the outputs."""
    tmp = tmp_path_factory.mktemp("gan")
    d = _jax_wrapper(seed=0)
    jgen = types.SimpleNamespace(state=types.SimpleNamespace(params={}),
                                 apply_fn=lambda p, x: x)
    for k in range(WARM):
        clean, noisy, _ = _batch(100 + k)
        d.learn(jax.random.PRNGKey(k), clean, noisy, jgen, loss_cs=LOSS_CS)
    d.update_learning_rate(1.0)
    d.update_learning_rate(1.0)  # num_bad 1: mid-window
    d.save_model(str(tmp), 3, "discriminator")
    port = gan.DiscriminatorWrapper(ARGS, "Hul112Disc", funit=DF, lr=1e-4, conditional=True,
                                    seed=9, patience=2,
                                    model_path=str(tmp / "discriminator_3.npz"))
    outs = []
    for k, fake_is_noisy in ((1, False), (2, True)):
        batch = _batch(k)
        key = jax.random.PRNGKey(10 + k)
        d.state, (lr_, lf_, ranges) = d._step(d.state, key, *_crops(*batch),
                                              jnp.asarray(fake_is_noisy))
        shape = (2, 1, 1, 1)
        got = port._step(*(_nchw(a) for a in _crops(*batch)), fake_is_noisy,
                         draws=_jax_draws(key, shape))
        outs.append(((float(lr_), float(lf_), np.asarray(ranges)),
                     tuple(t.numpy() for t in got)))
    return {"jax": d, "port": port, "outs": outs, "tmp": tmp, "jgen": jgen}


def test_resume_from_a_jax_checkpoint_restores_adam_and_the_scheduler(run):
    port = run["port"]
    assert port.scheduler.best == 1.0 and port.scheduler.num_bad == 1
    assert port.optimizer.hyper["learning_rate"] == np.float32(1e-4)
    assert port.optimizer.hyper["b1"] == np.float32(0.5)
    # WARM JAX steps before the save, two after it
    assert port.optimizer.count == port.optimizer.inner_count == WARM + 2
    assert int(run["jax"].state.opt_state.count) == WARM + 2


def test_two_discriminator_steps_match_jax(run):
    for (jl_r, jl_f, jr), (pl_r, pl_f, pr) in run["outs"]:
        assert abs(jl_r - float(pl_r)) <= TOL and abs(jl_f - float(pl_f)) <= TOL
        np.testing.assert_allclose(pr, jr, rtol=0, atol=TOL)
    d, port = run["jax"], run["port"]
    ck = port.checkpoint()
    _close(_sd(ck["params"], ck["state"]), _sd(d.state.params, d.state.model_state))
    for got, ref in zip(_port_moments(ck), _jax_opt_moments(d.state.opt_state)):
        got, ref = _sd(got), _sd(ref)
        assert sorted(got) == sorted(ref)
        for k in ref:
            scale = float(ref[k].abs().max())
            err = float((got[k] - ref[k]).abs().max())
            assert err <= 1e-3 * scale, (k, err, scale)


def test_learn_matches_jax(run):
    """``learn``: the generator forward, clip, crops, the noisy-target
    switch from the previous loss, the scalar loss and the ranges' text.
    Its update is not held here: on this batch JAX's fp32 gradient of one
    PReLU slope (``enc22to18dil.1``) is 5.4e-6 where a float64 torch step
    gives 1.2515e-4 and the port's fp32 step 1.2514e-4, so Adam moves that
    slope differently; the two steps above hold the update."""
    d, port = run["jax"], run["port"]
    clean, noisy, _ = _batch(3)
    d.loss = port.loss = 0.2  # fake targets noisy
    key = jax.random.PRNGKey(21)
    d.learn(key, clean, noisy, run["jgen"], loss_cs=LOSS_CS)
    port.learn(_nchw(clean), _nchw(noisy), _identity_gen(), LOSS_CS,
               draws=_jax_draws(key, (2, 1, 1, 1)))
    assert abs(port.loss - d.loss) <= TOL
    assert port.predictions_range == d.predictions_range
    assert port.optimizer.count == int(d.state.opt_state.count) == WARM + 3


def test_generator_step_with_the_d1_term_matches_jax(run):
    """One step of a one-conv generator with MSE + D1 against JAX's
    ``make_generator_train_step(disc_apply_fns=(pred_fn, None))``, then
    with ``grad_accum`` 2 (each microbatch normalized by its own batch
    statistics in both); the discriminator bit-unchanged by both."""
    port = run["port"]
    jd = run["jax"]
    ck = port.checkpoint()
    disc_params = ((ck["params"], ck["state"]), None)
    rng = np.random.default_rng(4)
    w0 = (rng.normal(0, 0.1, (3, 3, 3, 3)) + np.eye(3)[None, None] / 3).astype(np.float32)
    b0 = np.zeros(3, np.float32)
    weights = {"MSE": 1.0, "D1": 0.2}

    def japply(p, x):
        dn = lax.conv_dimension_numbers(x.shape, p["w"].shape, ("NHWC", "HWIO", "NHWC"))
        return lax.conv_general_dilated(x, p["w"], (1, 1), "SAME", dimension_numbers=dn) + p["b"]

    clean, noisy, _ = _batch(5)
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    for accum in (1, 2):
        opt = jax_steps.make_optimizer(1e-4, 0.5)
        jp = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
        jstate = jax_steps.TrainState(jp, opt.init(jp))
        jstep = jax_steps.make_generator_train_step(
            japply, opt, weights, LOSS_CS, disc_apply_fns=(jd.pred_fn, None),
            donate=False, grad_accum=accum)
        jstate, jm = jstep(jstate, jnp.asarray(clean), jnp.asarray(noisy), disc_params)

        model = torch.nn.Conv2d(3, 3, 3, padding=1)
        model.load_state_dict({"weight": torch.from_numpy(w0.transpose(3, 2, 0, 1).copy()),
                               "bias": torch.from_numpy(b0)})
        state = steps.TrainState(model, steps.make_optimizer(model, 1e-4, 0.5))
        step = steps.make_generator_train_step(steps.plain_apply, weights, LOSS_CS,
                                               grad_accum=accum,
                                               disc_fns=(port.pred_fn, None))
        m = step(state, _nchw(clean), _nchw(noisy))
        assert set(m) == set(jm) == {"MSE", "D1", "weighted"}
        for k in jm:
            assert abs(float(m[k]) - float(jm[k])) <= TOL, (accum, k)
        np.testing.assert_allclose(model.weight.detach().numpy().transpose(2, 3, 1, 0),
                                   np.asarray(jstate.params["w"]), rtol=0, atol=TOL)
        assert all(p.grad is None for p in port.model.parameters())
        for k, v in port.model.state_dict().items():
            assert torch.equal(v, before[k]), k


def test_d2_slot_and_remat_follow_the_d1_step(run):
    """A D2-only step reaches its term by slot (``weight_D2``), with the
    same numbers as the D1 step; ``remat`` gives the plain step's."""
    port = run["port"]
    clean, noisy, _ = _batch(6)
    out = {}
    for name, slots, remat in (("D1", (port.pred_fn, None), False),
                               ("D2", (None, port.pred_fn), False),
                               ("D1", (port.pred_fn, None), True)):
        torch.manual_seed(0)
        model = torch.nn.Conv2d(3, 3, 3, padding=1)
        state = steps.TrainState(model, steps.make_optimizer(model, 1e-4, 0.5))
        step = steps.make_generator_train_step(steps.plain_apply, {"MSE": 1.0, name: 0.2},
                                               LOSS_CS, remat=remat, disc_fns=slots)
        m = step(state, _nchw(clean), _nchw(noisy))
        assert set(m) == {"MSE", name, "weighted"}
        out[name, remat] = (m[name], m["weighted"], model.weight.detach().clone())
    for a, b in zip(out["D1", False], out["D2", False]):
        assert torch.equal(a, b)
    for a, b in zip(out["D1", False], out["D1", True]):
        assert torch.equal(a, b)


def test_port_checkpoint_loads_in_the_jax_wrapper(run, tmp_path):
    port = run["port"]
    port.save_model(str(tmp_path), 3, "discriminator")
    j = _jax_wrapper(seed=5, model_path=str(tmp_path / "discriminator_3.npz"))
    assert (j.scheduler.lr, j.scheduler.best, j.scheduler.num_bad) == \
        (port.scheduler.lr, port.scheduler.best, port.scheduler.num_bad)
    assert int(j.state.opt_state.count) == port.optimizer.count
    assert jax_steps.get_lr(j.state) == port.optimizer.hyper["learning_rate"]
    ck = port.checkpoint()
    _close(_sd(j.state.params, j.state.model_state), _sd(ck["params"], ck["state"]), atol=0)
    for got, ref in zip(_port_moments(ck), _jax_opt_moments(j.state.opt_state)):
        _close(_sd(got), _sd(ref), atol=0)


def test_exact_resume_takes_the_uninterrupted_step(run, tmp_path):
    port = run["port"]
    port.update_learning_rate(2.0)  # num_bad 2: the window moves
    port.save_model(str(tmp_path), 4, "discriminator")
    port.save_model(str(tmp_path), 9, "discriminator2")  # must not shadow it
    again = gan.DiscriminatorWrapper(ARGS, "Hul112Disc", funit=DF, lr=1e-4, conditional=True,
                                     seed=1, patience=2, model_path=str(tmp_path),
                                     keyword="discriminator")
    assert again.scheduler.num_bad == port.scheduler.num_bad == 2
    batch = [_nchw(a) for a in _crops(*_batch(7))]
    draws = _jax_draws(jax.random.PRNGKey(3), (2, 1, 1, 1))
    a = port._step(*batch, True, draws=draws)
    b = again._step(*batch, True, draws=draws)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for (k, x), y in zip(port.model.state_dict().items(), again.model.state_dict().values()):
        # BN's step counter is not in the checkpoint (and momentum is set)
        assert k.endswith("num_batches_tracked") or torch.equal(x, y), k
    assert again.optimizer.count == port.optimizer.count


def test_plateau_scheduler_and_targets_match_jax():
    ref, got = jax_gan.ReduceLROnPlateau(1e-4, patience=2), gan.ReduceLROnPlateau(1e-4, patience=2)
    for metric in (0.5, 0.4, 0.4, 0.45, 0.41, 0.39, 0.39 - 5e-9, 0.5, 0.5, 0.5):
        assert got.step(metric) == ref.step(metric)
        assert (got.best, got.num_bad) == (ref.best, ref.num_bad)
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (3, 4))
    for real in (True, False):
        for noisy in (True, False):
            np.testing.assert_array_equal(
                steps.fuzzy_targets(torch.from_numpy(np.asarray(u)), real, noisy).numpy(),
                np.asarray(jax_steps.fuzzy_targets(key, (3, 4), real, noisy)))
    assert steps.discriminator_scalar_loss(0.09, 0.16) == \
        jax_steps.discriminator_scalar_loss(0.09, 0.16) == 0.35
    # the port's own draws: in range, and a generator repeats them
    g = torch.Generator().manual_seed(3)
    t = steps.fuzzy_targets(torch.rand(1000, generator=g), True)
    assert 0.95 <= float(t.min()) and float(t.max()) <= 1.0 and float(t.std()) > 0.01
