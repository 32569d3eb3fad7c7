"""The port's generator train and eval steps (``train/steps.py``) and its
checkpoint layout (``models/params_io``) against the JAX trainer's.

Both start from one init (JAX params -> ``state_dict_from_jax``) at UtNet
funit 4 and take the same three steps on seeded batches of 2 x 168 px,
with every quality loss weighted (MS-SSIM on 164 px centre crops). The
JAX side runs ``UtNet.apply_fast``, the trainer's forward.

Tolerances, float32 with TF32 off: per-step metrics 1e-5 absolute (seen:
2e-6, the MS-SSIM windows' summation order); parameters after three
steps 5e-5 absolute (seen 1.5e-5), a sixth of one step's learning rate
(3e-4), against a movement of 9e-4: AMSGrad moves an element by about
the learning rate whatever its gradient's size, so an element whose
gradient is rounding noise moves by a noisy amount in both packages.
bf16: one step's metrics to 1e-4 absolute and the update's cosine with
JAX's above 0.95.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter

from nind_denoise_tpu.models import params_io as jax_params_io
from nind_denoise_tpu.models.utnet import UtNet as JaxUtNet
from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.tools.fixtures import write_jax_checkpoint
from nind_denoise_tpu_torch.train import steps

WEIGHTS = {"MSSSIM": 1, "L1": 0.5, "MSE": 0.5, "SSIM": 0.25}
LOSS_CS, LR, BETA1 = 164, 3e-4, 0.75


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch's default threads under the fast tier's parallel workers
    oversubscribe the host: two a worker, as test_torch_train_gan_cli.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(n, count, hw=168, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        c = gaussian_filter(rng.random((n, hw, hw, 3)), (0, 2, 2, 0))
        c = (c - c.min()) / np.ptp(c)
        noisy = np.clip(c + rng.normal(0, 0.08, c.shape), 0, 1)
        out.append((c.astype(np.float32), noisy.astype(np.float32)))
    return out


def _t(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


def _jax_apply(dtype):
    apply = partial(JaxUtNet.apply_fast, activation="PReLU")
    if dtype == "float32":
        return apply

    def bf16(tree):
        return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)

    return lambda p, x: apply(bf16(p), bf16(x)).astype(jnp.float32)


def _jax_run(params, batches, dtype="float32"):
    opt = jax_steps.make_optimizer(LR, BETA1)
    state = jax_steps.TrainState(jax.tree_util.tree_map(jnp.asarray, params),
                                 opt.init(params))
    step = jax_steps.make_generator_train_step(_jax_apply(dtype), opt, WEIGHTS,
                                               LOSS_CS, donate=False)
    metrics = []
    for c, n in batches:
        state, m = step(state, c, n)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port(params):
    model = params_io.generator_from_state_dict(params_io.state_dict_from_jax(params))
    return steps.TrainState(model, steps.make_optimizer(model, LR, BETA1))


def _port_run(params, batches, dtype="float32", **kw):
    state = _port(params)
    apply = steps.bf16_apply if dtype == "bfloat16" else steps.plain_apply
    step = steps.make_generator_train_step(apply, WEIGHTS, LOSS_CS, **kw)
    metrics = [{k: float(v) for k, v in step(state, _t(c), _t(n)).items()}
               for c, n in batches]
    return state, metrics


def _names(model):
    return [k for k, _ in model.named_parameters()]


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("init") / "g.npz")
    write_jax_checkpoint(path, 4, 0)
    return jax_params_io.load(path)


@pytest.fixture(scope="module")
def jax_fp32(init):
    batches = _batches(2, 3)
    state, metrics = _jax_run(init, batches)
    return batches, state, metrics


def test_three_steps_match_jax(init, jax_fp32):
    batches, jstate, jmetrics = jax_fp32
    state, metrics = _port_run(init, batches)
    for jm, m in zip(jmetrics, metrics):
        assert set(m) == set(jm) == {"SSIM", "MSSSIM", "L1", "MSE", "weighted"}
        for k in jm:
            assert abs(m[k] - jm[k]) < 1e-5, (k, m[k], jm[k])
        assert 0 < m["MSSSIM"] < 1  # out of MS-SSIM's dead zone
    ref = params_io.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    start = params_io.state_dict_from_jax(init)
    moved = max((ref[k] - start[k]).abs().max().item() for k in ref)
    assert moved > 5e-4
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=5e-5, err_msg=k)


def test_optimizer_leaves_follow_jax_after_steps(init, jax_fp32):
    """The trained optimizer state in the JAX trainer's leaf order: the
    counts and hyperparameters equal, each moment leaf close to its JAX
    twin (to 1 % of the largest leaf of its moment: gradients that are
    rounding noise differ more, relatively)."""
    batches, jstate, _ = jax_fp32
    state, _ = _port_run(init, batches)
    opt = state.opt
    mine = params_io.opt_leaves(opt.count, opt.hyper, opt.inner_count,
                                {m: dict(zip(_names(state.model), opt.moments(m)))
                                 for m in params_io.OPT_MOMENTS})
    ref = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate.opt_state)]
    assert len(mine) == len(ref) == 7 + 3 * 64
    for a, b in zip(ref[:7], mine[:7]):
        assert a.dtype == b.dtype and a.shape == b.shape == ()
        assert a == b
    n = 64
    for j in range(3):
        group = slice(7 + j * n, 7 + (j + 1) * n)
        scale = max(np.abs(a).max() for a in ref[group])
        for a, b in zip(ref[group], mine[group]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-2 * scale)


def test_optimizer_leaf_order_is_jax_tree_leaves(init):
    """Exact: moments set to (1, 2, 3) x the weights come out as JAX's
    ``tree_leaves`` of (1, 2, 3) x the params, after JAX's own count and
    hyperparameter leaves; and back again."""
    state = _port(init)
    opt = state.opt
    opt.count, opt.inner_count = 5, 5
    for k, m in enumerate(params_io.OPT_MOMENTS, 1):
        for buf, p in zip(opt.moments(m), opt.params):
            buf.copy_(p.detach() * k)
    mine = params_io.opt_leaves(opt.count, opt.hyper, opt.inner_count,
                                {m: dict(zip(_names(state.model), opt.moments(m)))
                                 for m in params_io.OPT_MOMENTS})
    jopt = jax_steps.make_optimizer(LR, BETA1)
    fresh = jax.tree_util.tree_leaves(jopt.init(init))
    want = [np.asarray(5, np.int32)]
    want += [np.asarray(v, np.float32) for v in (BETA1, 0.999, 1e-8, 0.0, LR)]
    want += [np.asarray(5, np.int32)]
    for k in (1, 2, 3):
        want += [np.asarray(a * np.float32(k)) for a in jax.tree_util.tree_leaves(init)]
    assert len(mine) == len(want) == len(fresh)
    for a, b, f in zip(want, mine, fresh):
        assert a.shape == b.shape == np.shape(f) and b.dtype == np.asarray(f).dtype
        np.testing.assert_array_equal(b, a)
    # the JAX trainer restores them, and the port reads them back exactly
    restored = jax_steps.restore_opt_state(jopt, init, mine)
    assert int(restored.inner_state[0].count) == 5
    count, hyper, inner, moments = params_io.opt_from_leaves(mine, init)
    assert (count, inner) == (5, 5) and hyper == opt.hyper
    for k, m in enumerate(params_io.OPT_MOMENTS, 1):
        for name, buf in zip(_names(state.model), opt.moments(m)):
            assert torch.equal(moments[m][name].reshape(buf.shape), buf)
    with pytest.raises(ValueError, match="leaves expected"):
        params_io.opt_from_leaves(mine[:-1], init)


def test_jax_from_state_dict_inverts_state_dict_from_jax(init, tmp_path):
    tree = params_io.jax_from_state_dict(params_io.state_dict_from_jax(init))
    assert params_io.leaf_paths(tree) == params_io.leaf_paths(init)
    for path in params_io.leaf_paths(init):
        a, b = init, tree
        for k in path:
            a, b = a[k], b[k]
        assert a.shape == b.shape and b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # save writes the JAX package's format: its loader reads every leaf
    path = str(tmp_path / "g.npz")
    params_io.save({"params": tree, "state": None, "opt": [np.int32(3)], "epoch": 2}, path)
    back = jax_params_io.load(path)
    assert back["epoch"] == 2 and back["state"] is None and int(back["opt"][0]) == 3
    np.testing.assert_array_equal(back["params"]["up1"]["w"], init["up1"]["w"])


def test_grad_accum_2_equals_the_full_batch_step(init):
    (c, n), = _batches(4, 1, seed=1)
    full, mfull = _port_run(init, [(c, n)])
    acc, macc = _port_run(init, [(c, n)], grad_accum=2)
    for k in mfull[0]:
        assert abs(mfull[0][k] - macc[0][k]) < 1e-6, k
    for p, q in zip(full.model.parameters(), acc.model.parameters()):
        scale = p.grad.abs().max().item()
        assert (p.grad - q.grad).abs().max().item() <= 1e-4 * scale
        assert (p - q).abs().max().item() <= 1e-6
    with pytest.raises(ValueError, match="must divide"):
        _port_run(init, [(c[:3], n[:3])], grad_accum=2)
    with pytest.raises(ValueError, match=">= 1"):
        steps.make_generator_train_step(steps.plain_apply, WEIGHTS, LOSS_CS, grad_accum=0)


def test_remat_equals_the_plain_step(init, jax_fp32):
    batches = jax_fp32[0][:1]
    plain, mp = _port_run(init, batches)
    remat, mr = _port_run(init, batches, remat=True)
    assert mp == mr
    for p, q in zip(plain.model.parameters(), remat.model.parameters()):
        assert torch.equal(p, q)


def test_bf16_step_matches_jax_within_bf16(init, jax_fp32):
    batches = jax_fp32[0][:1]
    jstate, jm = _jax_run(init, batches, "bfloat16")
    state, m = _port_run(init, batches, "bfloat16")
    for k in jm[0]:
        assert abs(m[0][k] - jm[0][k]) < 1e-4, k
    start = params_io.state_dict_from_jax(init)
    ref = params_io.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = state.model.state_dict()
    du = torch.cat([(ref[k] - start[k]).flatten() for k in ref])
    dv = torch.cat([(got[k] - start[k]).flatten() for k in ref])
    assert torch.nn.functional.cosine_similarity(du, dv, dim=0).item() > 0.95
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_eval_step_matches_jax(init):
    (c, n), = _batches(1, 1, seed=2)
    jstep = jax_steps.make_generator_eval_step(_jax_apply("float32"), WEIGHTS, LOSS_CS,
                                               compute_ssim_anyway=True)
    jm = jstep(jax.tree_util.tree_map(jnp.asarray, init), c, n)
    step = steps.make_generator_eval_step(steps.plain_apply, WEIGHTS, LOSS_CS,
                                          compute_ssim_anyway=True)
    m = step(_port(init).model, _t(c), _t(n))
    assert set(m) == set(jm)
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) < 1e-5, k


def test_center_crop_and_weights_match_jax():
    x = np.arange(2 * 7 * 9 * 3, dtype=np.float32).reshape(2, 7, 9, 3)
    np.testing.assert_array_equal(steps.center_crop(_t(x), 4).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_steps.center_crop(x, 4)))
    for w in ({}, {"MSE": 2, "L1": 2}, {"MSSSIM": 1}, {"SSIM": 0.3, "D1": 0.7}):
        assert steps.normalize_weights(w) == jax_steps.normalize_weights(w)
