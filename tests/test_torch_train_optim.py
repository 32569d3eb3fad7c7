"""The port's optimizer (``train/optim.AmsGrad``) against the JAX trainer's,
``optax.inject_hyperparams(optax.amsgrad)`` built by
``nind_denoise_tpu.train.steps.make_optimizer``.

The gradients grow for three steps and then shrink, so the second moment
falls: there optax's maximum of the bias-corrected moment and torch's
built-in amsgrad (the maximum of the raw moment) part. The learning rate
changes between steps through both packages' ``set_lr``. The port must
match optax to 1e-7 absolute on parameters of order 1 (the same float32
operations in the same order); the witness shows that
``torch.optim.Adam(amsgrad=True)`` misses by more than 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.train import steps
from nind_denoise_tpu_torch.train.optim import AmsGrad

SHAPES = [(3, 3, 4, 5), (5,), ()]
STEPS = 20


def _run(beta1=0.75):
    rng = np.random.default_rng(0)
    p0 = [np.asarray(rng.normal(0, 1, s), np.float32) for s in SHAPES]
    grads = [[np.asarray(rng.normal(0, 1, s) * (3.0 if k < 3 else 0.3), np.float32)
              for s in SHAPES] for k in range(STEPS)]
    lrs = [1e-4 * 0.95 ** (k // 5) for k in range(STEPS)]

    opt = jax_steps.make_optimizer(1e-4, beta1)
    jp = {str(i): jnp.asarray(a) for i, a in enumerate(p0)}
    jstate = jax_steps.TrainState(jp, opt.init(jp))
    tp = [torch.from_numpy(a.copy()) for a in p0]
    tstate = steps.TrainState(torch.nn.Module(), AmsGrad(tp, 1e-4, b1=beta1, b2=0.999))
    wit = [torch.from_numpy(a.copy()) for a in p0]
    adam = torch.optim.Adam(wit, lr=1e-4, betas=(beta1, 0.999), amsgrad=True)
    for k in range(STEPS):
        jax_steps.set_lr(jstate, lrs[k])
        steps.set_lr(tstate, lrs[k])
        for g in adam.param_groups:
            g["lr"] = lrs[k]
        upd, jstate.opt_state = opt.update(
            {str(i): jnp.asarray(g) for i, g in enumerate(grads[k])},
            jstate.opt_state, jstate.params)
        jstate.params = optax.apply_updates(jstate.params, upd)
        for t, w, g in zip(tp, wit, grads[k]):
            t.grad = torch.from_numpy(g)
            w.grad = torch.from_numpy(g)
        tstate.opt.step()
        adam.step()
    ref = [np.asarray(jstate.params[str(i)]) for i in range(len(SHAPES))]
    return p0, ref, tp, wit, jstate, tstate


@pytest.mark.parametrize("beta1", [0.75, 0.5])
def test_amsgrad_matches_optax_over_20_steps(beta1):
    p0, ref, got, _, jstate, tstate = _run(beta1)
    moved = max(np.abs(r - a).max() for r, a in zip(ref, p0))
    assert moved > 1e-4
    for r, t in zip(ref, got):
        np.testing.assert_allclose(t.numpy(), r, rtol=0, atol=1e-7)
    # the moments too, and both step counts
    inner = jstate.opt_state.inner_state[0]
    for name in ("mu", "nu", "nu_max"):
        for i, buf in enumerate(tstate.opt.moments(name)):
            np.testing.assert_allclose(buf.numpy(), np.asarray(getattr(inner, name)[str(i)]),
                                       rtol=1e-6, atol=0, err_msg=name)
    assert tstate.opt.count == int(jstate.opt_state.count) == STEPS
    assert tstate.opt.inner_count == int(inner.count) == STEPS


def test_torch_builtin_amsgrad_is_not_optax():
    """Witness: torch's amsgrad keeps max(raw nu), optax max(nu_hat)."""
    _, ref, _, wit, _, _ = _run()
    diff = max(np.abs(r - w.numpy()).max() for r, w in zip(ref, wit))
    assert diff > 1e-5, diff


def test_lr_hyperparameter_is_float32_like_optax():
    """get_lr/set_lr/decay_lr round through float32, as optax holds it."""
    opt = jax_steps.make_optimizer(3e-4, 0.5)
    jstate = jax_steps.TrainState({"w": jnp.zeros(2)}, opt.init({"w": jnp.zeros(2)}))
    tstate = steps.TrainState(torch.nn.Module(),
                              steps.make_optimizer(torch.nn.Linear(2, 1), 3e-4, 0.5))
    assert steps.get_lr(tstate) == jax_steps.get_lr(jstate)
    for _ in range(3):
        jstate, jlr = jax_steps.decay_lr(jstate, 0.95)
        tstate, tlr = steps.decay_lr(tstate, 0.95)
        assert tlr == jlr and steps.get_lr(tstate) == jax_steps.get_lr(jstate)
    assert tstate.opt.hyper == {k: float(v) for k, v in jstate.opt_state.hyperparams.items()}


def test_missing_gradient_counts_as_zero():
    p = torch.ones(3, requires_grad=True)
    opt = AmsGrad([p], 1e-3, b1=0.9)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3)) and opt.count == 1
    with pytest.raises(KeyError):
        opt.set_hyper(momentum=0.9)
