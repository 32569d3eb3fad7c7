"""The port's UNet (``models/unet.py``) against the JAX package's: the
forward in eval mode, train mode (output and new running stats) and
``find_noise``, in fp32 and bf16; the tile engine; one train step with its
BatchNorm state (``grad_accum`` 1 and 2); the trainer's train-mode
``infer``; the preset's MS-SSIM refusal; checkpoints in both directions.

Weights: ``tools/fixtures.unet_tree`` (numpy, seeded), through
``unet_state_dict_from_jax`` into the port. JAX runs jitted.

Tolerances, float32 on the CPU: forwards and BN stats 5e-5 absolute (seen
~1e-6); the engine 5e-5 absolute and > 80 dB, the bar of
tests/test_torch_engine.py; one step's losses 1e-5 absolute, the BN stats
5e-5, its gradient 1e-2 of its norm. That bar is wide because a ReLU
input within rounding of 0 takes either side in either package: one such
element of the last block, gradient 4e-6, sits in a gradient of norm 9e-4
spread over 250k elements, and the BN backward spreads it over its channel
(seen, grad_accum 1: the port's fp32 gradient 2.3e-3 of the norm from its
float64 one, JAX's 4e-6; grad_accum 2: JAX's 1.4e-3 from the port's
float64). A semantic fault (statistics, state threading, microbatch
scaling) moves it by far more. The parameters after the port's AMSGrad step (lr 1e-3)
within 2.5e-7 (two fp32 ulps below 2; XLA fuses the update) of optax's
AMSGrad on the port's gradient: a fresh AMSGrad
moves an element by about the learning rate whatever its gradient's size,
so comparing parameters across packages would only read the noise of
gradients that cancel (the biases of the convs before each BatchNorm are
exactly 0 in exact arithmetic).
bf16 (convs in bf16, BatchNorm in fp32, in both packages): the two differ
by their rounding order (seen: 0.012 max against outputs in [0.17, 0.92]),
so each is held against the fp32 forward: the port's error at most 1.25 x
JAX's (max and RMS; seen 0.0106 vs 0.0128 max), the two within 2 x JAX's
max error of each other.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.ndimage import gaussian_filter

import cv2
import jax
import jax.numpy as jnp

from nind_denoise_tpu.engine import tile_engine as jte
from nind_denoise_tpu.models import params_io as jax_params_io
from nind_denoise_tpu.models.unet import UNet as JaxUNet
from nind_denoise_tpu.ops import losses as jax_losses
from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.engine import tile_engine as tte
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.models.unet import UNet
from nind_denoise_tpu_torch.tools import fixtures
from nind_denoise_tpu_torch.train import loop, steps

ATOL = 5e-5
WEIGHTS = {"MSE": 1.0, "L1": 0.5}
LR, BETA1, LOSS_CS = 1e-3, 0.9, 32
SGD_LR = 1e3
GRAD_TOL = 1e-2
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "nind_denoise_tpu_torch", "configs")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch on two threads: the fast tier runs six test processes on one
    host, and these full-width forwards and steps would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return fixtures.unet_tree(3)


@pytest.fixture(scope="module")
def x():
    # odd at every level: 44 -> 22 -> 11 -> 5 -> 2, 52 -> 26 -> 13 -> 6 -> 3
    return np.random.default_rng(0).random((2, 44, 52, 3), np.float32)


def _port(tree, **kw):
    params, state = tree
    model = params_io.generator_from_state_dict(
        params_io.unet_state_dict_from_jax(params, state), network="UNet")
    model.find_noise = kw.get("find_noise", False)
    return model


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _jax_fwd(train, find_noise=False):
    return jax.jit(lambda p, x, s: JaxUNet.apply(p, x, s, train=train, find_noise=find_noise))


@pytest.mark.parametrize("train,find_noise", [(False, False), (True, False), (False, True)])
def test_forward_matches_jax(tree, x, train, find_noise):
    params, state = tree
    ref, ref_state = _jax_fwd(train, find_noise)(params, x, state)
    model = _port(tree, find_noise=find_noise).train(train)
    with torch.no_grad():
        got = model(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)
    _, got_state = params_io.unet_jax_from_state_dict(model.state_dict())
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref_state),
                            jax.tree_util.tree_leaves(got_state)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=ATOL, err_msg=str(path))
    if train:  # the stats moved
        assert not np.allclose(state["inc"]["bn0"]["mean"], got_state["inc"]["bn0"]["mean"])


def test_bf16_forward_matches_jax(tree, x):
    params, state = tree
    fwd = _jax_fwd(False)
    ref32 = np.asarray(fwd(params, x, state)[0])
    ref = np.asarray(fwd(params, jnp.asarray(x, jnp.bfloat16), state)[0].astype(jnp.float32))
    model = _port(tree).eval().cast_convs(torch.bfloat16)
    bn = model.inc.conv.conv[1]
    assert bn.weight.dtype == bn.running_var.dtype == torch.float32
    with torch.no_grad():
        got = model(_nchw(x).bfloat16())
    assert got.dtype == torch.bfloat16
    got = _nhwc(got)
    jax_err, port_err = np.abs(ref - ref32), np.abs(got - ref32)
    assert port_err.max() <= 1.25 * jax_err.max(), (port_err.max(), jax_err.max())
    assert np.sqrt(np.mean(port_err ** 2)) <= 1.25 * np.sqrt(np.mean(jax_err ** 2))
    assert np.abs(got - ref).max() <= 2 * jax_err.max()


def test_frozen_normalizes_by_the_batch_and_keeps_the_stats(tree, x):
    params, state = tree
    ref, _ = _jax_fwd(True)(params, x, state)
    model = _port(tree).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad(), model.frozen_stats():
        got = model(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_engine_matches_jax(tree):
    params, state = tree
    kw = dict(cs=104, ucs=88, ol=6, batch_size=3, compute_dtype="float32",
              precision="float32")
    jax_eng = jte.make_engine("UNet", (params, state), **kw)
    port_eng = tte.make_engine("UNet", _port(tree), device="cpu", **kw)
    for hw in ((150, 170), (97, 131)):
        img = np.random.default_rng(hw[0]).random((3, *hw), dtype=np.float32)
        ref, got = jax_eng.denoise_chw(img), port_eng.denoise_chw(img)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-4)
        assert 10 * np.log10(1.0 / np.mean((got - ref) ** 2)) > 80
    tiny = (np.random.default_rng(1).random((40, 50, 3)) * 255).astype(np.uint8)
    r8 = jax_eng.denoise_tiny(tiny, 255.0, out_dtype="uint8")
    g8 = port_eng.denoise_tiny(tiny, 255.0, out_dtype="uint8")
    assert np.abs(g8.astype(int) - r8.astype(int)).max() <= 1


def test_engine_refuses_int8_for_unet(tree):
    for dt in ("int8", "int8_static"):
        with pytest.raises(ValueError, match="only supported for UtNet"):
            tte.resolve_apply_fn("UNet", _port(tree), dt, device="cpu")


def _crops(n=2, hw=36, seed=1):
    rng = np.random.default_rng(seed)
    c = gaussian_filter(rng.random((n, hw, hw, 3)), (0, 2, 2, 0))
    c = ((c - c.min()) / np.ptp(c)).astype(np.float32)
    noisy = np.clip(c + rng.normal(0, 0.08, c.shape), 0, 1).astype(np.float32)
    return c, noisy


def _rel(leaves, ref_flat):
    got = np.concatenate([np.asarray(g, np.float64).ravel() for g in leaves])
    return np.linalg.norm(got - ref_flat) / np.linalg.norm(ref_flat)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(tree, grad_accum):
    """One step of each package's ``make_generator_train_step`` from the
    same weights and BN state. JAX's step runs under SGD with a learning
    rate of 1e3, which hands back its gradient exactly enough; the port's
    AMSGrad update is held to optax's AMSGrad on the port's gradient."""
    import optax

    params, state = tree
    clean, noisy = _crops()
    sgd = optax.sgd(SGD_LR)
    jstep = jax_steps.make_generator_train_step(
        lambda p, x, ms: JaxUNet.apply(p, x, ms, train=True), sgd, WEIGHTS, LOSS_CS,
        donate=False, stateful=True, grad_accum=grad_accum)
    js, jm = jstep(jax_steps.TrainState(params, sgd.init(params), state), clean, noisy)
    jgrads = jax.tree_util.tree_map(lambda a, b: (np.asarray(a) - np.asarray(b)) / SGD_LR,
                                    params, js.params)
    ams = jax_steps.make_optimizer(LR, BETA1)

    model = _port(tree).train()
    pstate = steps.TrainState(model, steps.make_optimizer(model, LR, BETA1))
    pm = steps.make_generator_train_step(steps.plain_apply, WEIGHTS, LOSS_CS,
                                         grad_accum=grad_accum)(pstate, _nchw(clean), _nchw(noisy))
    for k in jm:
        assert abs(float(pm[k]) - float(jm[k])) < 1e-5, k
    got_p, got_s = params_io.unet_jax_from_state_dict(model.state_dict())
    got_g, _ = params_io.unet_jax_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()})
    gj = jax.tree_util.tree_leaves(jgrads)
    gp = jax.tree_util.tree_leaves(got_g)
    flat_j = np.concatenate([g.ravel() for g in gj])
    assert _rel(gp, flat_j) <= GRAD_TOL
    # the update: optax's AMSGrad applied to the port's own gradient
    ams_step = jax.jit(lambda g, p: optax.apply_updates(p, ams.update(g, ams.init(p), p)[0]))
    for a, b in zip(jax.tree_util.tree_leaves(ams_step(got_g, params)),
                    jax.tree_util.tree_leaves(got_p)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=2.5e-7)
    for a, b in zip(jax.tree_util.tree_leaves(js.model_state), jax.tree_util.tree_leaves(got_s)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=ATOL)


def test_remat_step_updates_the_stats_once(tree):
    clean, noisy = _crops()
    out = []
    for remat in (False, True):
        model = _port(tree).train()
        st = steps.TrainState(model, steps.make_optimizer(model, LR, BETA1))
        steps.make_generator_train_step(steps.plain_apply, WEIGHTS, LOSS_CS, remat=remat)(
            st, _nchw(clean), _nchw(noisy))
        out.append(model.state_dict())
    for k, v in out[0].items():
        torch.testing.assert_close(out[1][k], v, rtol=0, atol=1e-6)


def test_eval_step_uses_the_running_stats(tree):
    """Validation normalizes with the running stats (JAX's eval-mode
    forward) and leaves the model in train mode with its stats unchanged."""
    params, state = tree
    clean, noisy = _crops()
    ref, _ = _jax_fwd(False)(params, noisy, state)
    want = np.mean((np.clip(np.asarray(ref), 0, 1)[:, 2:34, 2:34] - clean[:, 2:34, 2:34]) ** 2)
    model = _port(tree).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = steps.make_generator_eval_step(steps.plain_apply, {"MSE": 1}, LOSS_CS)(
        model, _nchw(clean), _nchw(noisy))
    assert abs(float(m["MSE"]) - want) < 1e-6
    assert model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("unet_train")
    root = base / "SYN_64_36"
    rng = np.random.default_rng(5)
    for s in range(1):
        for xx in (0, 64):
            clean = gaussian_filter(rng.random((64, 64, 3)), (3, 3, 0))
            clean = (clean - clean.min()) / np.ptp(clean)
            for iso, sigma in (("ISO200", 0.0), ("ISO3200", 0.08)):
                d = root / f"scene{s}" / iso
                d.mkdir(parents=True, exist_ok=True)
                img = np.clip(clean + rng.normal(0, sigma, clean.shape), 0, 1)
                cv2.imwrite(str(d / f"SYN_scene{s}_{iso}_{xx}_0_36.png"),
                            (img * 65535).astype(np.uint16))
    d = root / "scene0"
    vy = base / "val.yaml"
    vy.write_text(yaml.safe_dump([[str(d / "ISO200" / "SYN_scene0_ISO200_0_0_36.png"),
                                   str(d / "ISO3200" / "SYN_scene0_ISO3200_0_0_36.png")]]))
    init = str(base / "init.npz")
    fixtures.write_unet_checkpoint(init, 3)
    args = ["--train_data", str(root), "--test_reserve", "0", "--g_network", "UNet",
            "--cs", "36", "--loss_cs", "32", "--batch_size", "2", "--g_lr", "1e-3",
            "--beta1", "0.9", "--weight_MSSSIM", "0", "--weight_MSE", "1",
            "--validation_set_yaml", str(vy), "--threads", "1", "--device", "cpu",
            "--debug_options", "output_val_images"]
    return {"base": base, "args": args, "init": init}


def _only(d):
    (exp,) = os.listdir(d)
    return os.path.join(d, exp)


def test_trainer_checkpoints_cross_both_ways(data, tree):
    """A short port run (two epochs of two steps from the fixture file)
    writes checkpoints that JAX's ``params_io`` loads and its optimizer
    restores, key for key; the port resumes from its own checkpoint and
    from one JAX's trainer writes (optax's state of the same tree)."""
    exp = loop.main(data["args"] + ["--g_model_path", data["init"], "--epochs", "3",
                                    "--models_dpath", str(data["base"] / "port")])
    ck = os.path.join(exp, "generator_2.npz")
    assert os.path.isdir(os.path.join(exp, "val", "2"))
    model = params_io.load_generator(ck, "UNet")
    jparams, jstate = jax_params_io.load_generator(ck, "UNet")
    sd = params_io.unet_state_dict_from_jax(jparams, jstate)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    jtree = jax_params_io.load(ck)
    opt = jax_steps.make_optimizer(LR, BETA1)
    jopt = jax_steps.restore_opt_state(opt, jparams, jtree["opt"])
    wrapper = loop.GeneratorWrapper(
        loop.build_parser().parse_args(data["args"] + ["--g_model_path", ck]),
        {"MSE": 1}, steps.plain_apply, _NullPrinter(), torch.device("cpu"))
    names = [k for k, _ in wrapper.state.model.named_parameters()]
    for m, moment in (("mu", jopt.inner_state[0].mu), ("nu", jopt.inner_state[0].nu),
                      ("nu_max", jopt.inner_state[0].nu_max)):
        got = params_io.unet_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, moment), None)
        for k, buf in zip(names, wrapper.state.opt.moments(m)):
            assert torch.equal(got[k], buf), (m, k)
    assert wrapper.resume_epoch == 2

    # a JAX trainer checkpoint (its layout: params, state, optax leaves, epoch)
    params, state = tree
    jck = str(data["base"] / "generator_5.npz")
    jax_params_io.save({"params": params, "state": state,
                        "opt": jax_steps.opt_state_leaves(opt.init(params)), "epoch": 5}, jck)
    # --compute_dtype bfloat16 warns and trains UNet in float32, as JAX does
    resumed = loop.main(data["args"] + ["--g_model_path", jck, "--epochs", "7",
                                        "--compute_dtype", "bfloat16",
                                        "--models_dpath", str(data["base"] / "resumed")])
    with open(os.path.join(resumed, "train.log")) as f:
        assert "training UNet in float32" in f.read()
    with open(os.path.join(resumed, "trainres.json")) as f:
        res = json.load(f)
    assert np.isfinite(res["6"]["train_weighted_loss"])
    got = params_io.load_generator(os.path.join(resumed, "generator_6.npz"), "UNet")
    moved = got.state_dict()["inc.conv.conv.1.running_mean"]
    assert not torch.equal(moved, torch.from_numpy(state["inc"]["bn0"]["mean"]))


class _NullPrinter:
    def print(self, *a, **kw):
        pass


def test_trainer_infer_is_train_mode_and_keeps_the_stats(tree, x):
    params, state = tree
    ref, _ = _jax_fwd(True)(params, x, state)
    gen = loop.GeneratorWrapper.__new__(loop.GeneratorWrapper)
    gen.apply_fn = steps.plain_apply
    gen.state = steps.TrainState(_port(tree).train(), None)
    before = {k: v.clone() for k, v in gen.state.model.state_dict().items()}
    got = gen.infer(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=ATOL)
    for k, v in gen.state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_preset_with_msssim_raises_as_jax(data, tmp_path):
    """``train_conf_unet.yaml`` over the defaults keeps ``weight_MSSSIM 1``
    with ``loss_cs 161``, below MS-SSIM's 162 px: JAX's loss raises on the
    first step, and so does the port's trainer (batch and crop cut to the
    CPU), with the same message."""
    with pytest.raises(ValueError) as ref:
        jax_losses.ms_ssim_loss(jnp.zeros((1, 161, 161, 3)), jnp.zeros((1, 161, 161, 3)))
    root = tmp_path / "SYN_176_161"
    rng = np.random.default_rng(0)
    for iso in ("ISO200", "ISO3200"):
        d = root / "s0" / iso
        d.mkdir(parents=True)
        cv2.imwrite(str(d / f"SYN_s0_{iso}_0_0_176.png"),
                    (rng.random((176, 176, 3)) * 65535).astype(np.uint16))
    argv = ["--config", os.path.join(CONFIGS, "train_conf_unet.yaml"),
            "--train_data", str(root), "--test_reserve", "0", "--batch_size", "1",
            "--cs", "168", "--validation_interval", "0", "--threads", "1",
            "--device", "cpu", "--models_dpath", str(tmp_path / "m")]
    with pytest.raises(ValueError) as got:
        loop.main(argv)
    assert str(got.value) == str(ref.value)
    assert isinstance(UNet(), torch.nn.Module)
