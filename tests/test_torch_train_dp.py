"""The port's data-parallel training (``parallel/data_parallel.py`` and the
trainer's ``--coordinator/--num_processes/--process_id``) on the CPU: two
``gloo`` ranks at 127.0.0.1, run as subprocesses of the port only
(``tests/_torch_dp_child.py`` and ``python -m
nind_denoise_tpu_torch.train.loop``), two torch threads each.

Against the JAX trainer with the batch sharded over ``make_mesh(2)`` (the
conftest's CPU devices), from one JAX parameter tree:

* UtNet funit 8: two DP generator steps (AMSGrad, MSE), with
  ``--grad_accum`` 1 and 2;
* UNet: two DP steps under plain SGD, its running stats after the first
  against JAX's global-batch ones;
* a conditional Hul112Disc at funit 1 resumed from a JAX checkpoint (eight
  JAX steps old, as ``tests/test_torch_gan.py`` resumes it): two DP
  discriminator steps with JAX's uniform draws at the global shape, then a
  ``learn``.

Tolerances: the generators' parameters ``rtol 5e-4, atol 1e-5`` after two
steps (the bar JAX's own two-process check holds, tests/_multihost_train_child.py),
losses 1e-5; UNet's running stats 1e-6; the discriminator's two steps at
``tests/test_torch_gan.py``'s (1e-6 absolute; Adam's moments 1e-3 of each
tensor's largest entry). Both ranks end bit-equal.

The CLI (UtNet funit 8, a Hul112Disc as D1, two epochs of three batches of
four) as two ranks, from torchrun's variables and from JAX's three flags
(with ``--device_cache``, which data parallelism turns off), against one
process on the same seed: the chief's checkpoints within the generators'
tolerance (learning rates 3e-5 and 1e-5, where a fresh optimizer's noise
stays under it), ``trainres.json``'s losses within 1e-6, the same D/G
schedule, the replicas' digests equal; only the chief writes checkpoints,
rank 1 logs to ``<expname>_rank1``. Every command-line process starts with
the module, so they run while the JAX references compile. A shutdown flag raised on
rank 1 alone checkpoints both ranks at the same batch. Refusals: two
processes with a batch the DP predicate rejects raise before anything is
written.
"""

import json
import os
import re
import socket
import subprocess
import sys
import types
from functools import partial

import cv2
import numpy as np
import pytest
import torch
import yaml
from scipy.ndimage import gaussian_filter

import jax
import jax.numpy as jnp

from nind_denoise_tpu.models import hul as jax_hul
from nind_denoise_tpu.models.unet import UNet as JaxUNet
from nind_denoise_tpu.models.utnet import UtNet as JaxUtNet
from nind_denoise_tpu.parallel import mesh as jax_mesh
from nind_denoise_tpu.train import gan as jax_gan
from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.parallel import data_parallel
from nind_denoise_tpu_torch.tools import fixtures
from nind_denoise_tpu_torch.train import gan, loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_dp_child.py")
CHILD_TIMEOUT = 240
RTOL, ATOL, LOSS_TOL, STATS_TOL = 5e-4, 1e-5, 1e-5, 1e-6
D_TOL = 1e-6  # tests/test_torch_gan.py's
# UtNet: the JAX two-process check's setup (funit 8, MSE, 104 px, AMSGrad)
U_LR, U_BETA1, U_LOSS_CS = 1e-3, 0.5, 96
# UNet: tests/test_torch_unet.py's weights and loss, plain SGD (see the test)
N_LR, N_LOSS_CS, N_WEIGHTS = 0.005, 32, {"MSE": 1.0, "L1": 0.5}
D_CS, D_LOSS_CS, D_WARM = 120, 112, 8
# XLA's backend optimization level 1 for the JAX references' compiles
# (tests/test_torch_relics.py): the same functions, compiled in about half the time
FAST_COMPILE = {"xla_backend_optimization_level": 1}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2", **extra)
    return env


def _start(argvs, envs):
    return [subprocess.Popen(a, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for a, e in zip(argvs, envs)]


def _wait(procs):
    """The processes' outputs, once all have exited (each must exit 0)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs


def _smooth(rng, n, hw):
    c = gaussian_filter(rng.random((n, hw, hw, 3)), (0, 2, 2, 0))
    c = ((c - c.min()) / np.ptp(c)).astype(np.float32)
    noisy = np.clip(c + rng.normal(0, 0.08, c.shape), 0, 1).astype(np.float32)
    return c, noisy


def _jax_draws(key, shape):
    kr, kf = jax.random.split(key)
    return tuple(np.asarray(jax.random.uniform(k, shape)).transpose(0, 3, 1, 2)
                 for k in (kr, kf))


def _jax_disc():
    """JAX's DiscriminatorWrapper (Hul112Disc, funit 1, conditional) with
    the port's seeded init as its fresh weights (tests/test_torch_gan.py)."""
    def init(key, input_channels=3, funit=32, **_):
        return params_io.hul_jax_from_state_dict(
            gan.init_disc("Hul112Disc", input_channels, funit, 0).state_dict(), "Hul112Disc")

    args = types.SimpleNamespace(beta1=0.5, models_dpath=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hul.Hul112Disc, "init", classmethod(lambda cls, *a, **k: init(*a, **k)))
        return jax_gan.DiscriminatorWrapper(args, network="Hul112Disc", funit=1, lr=1e-4,
                                            conditional=True, patience=2, seed=0)


def _d_crops(clean, noisy, generated):
    c = lambda a: np.asarray(jax_steps.center_crop(jnp.asarray(a), D_LOSS_CS))  # noqa: E731
    return c(clean), c(generated), c(noisy)


def _fast(step):
    """The jitted ``step`` compiled once, at ``FAST_COMPILE``, on its first
    call's arguments (their shapes and shardings), and reused."""
    compiled = []

    def run(*args):
        if not compiled:
            compiled.append(step.lower(*args).compile(FAST_COMPILE))
        return compiled[0](*args)
    return run


def _inputs(tmp):
    """One JAX tree each, the global batches, and the JAX discriminator
    after its warm steps and checkpoint; writes ``in.npz`` for the ranks."""
    rng = np.random.default_rng(11)
    ck = str(tmp / "utnet.npz")
    fixtures.write_jax_checkpoint(ck, 8, seed=4)
    utnet = jax.tree_util.tree_map(np.asarray, params_io.load_npz(ck))
    u = [_smooth(rng, 4, 104) for _ in range(2)]
    unet_params, unet_state = fixtures.unet_tree(3)
    n = [_smooth(rng, 4, 36) for _ in range(2)]

    d = _jax_disc()
    d._unsharded_step, d._step = d._step, _fast(d._step)
    jgen = types.SimpleNamespace(state=types.SimpleNamespace(params={}), apply_fn=lambda p, x: x)
    for k in range(D_WARM):
        clean, noisy = _smooth(np.random.default_rng(100 + k), 2, D_CS)
        d.learn(jax.random.PRNGKey(k), clean, noisy, jgen, loss_cs=D_LOSS_CS)
    d.update_learning_rate(1.0)
    d.update_learning_rate(1.0)
    d.save_model(str(tmp), 3, "discriminator")
    d_batches, d_keys = [], []
    for i in range(2):
        clean, noisy = _smooth(np.random.default_rng(200 + i), 4, D_CS)
        generated = gaussian_filter(noisy, (0, 1, 1, 0)).astype(np.float32)
        d_batches.append(_d_crops(clean, noisy, generated))
        d_keys.append(jax.random.PRNGKey(10 + i))
    draws = [_jax_draws(k, (4, 1, 1, 1)) for k in d_keys]
    # the learn at the warm steps' batch of 2 (one row a rank): JAX's compile
    learn_batch = _smooth(np.random.default_rng(300), 2, D_CS)
    learn_key = jax.random.PRNGKey(21)
    learn_draws = _jax_draws(learn_key, (2, 1, 1, 1))
    path = str(tmp / "in.npz")
    np.savez(path, utnet=np.array(utnet, dtype=object),
             u_clean=np.stack([b[0] for b in u]), u_noisy=np.stack([b[1] for b in u]),
             u_loss_cs=U_LOSS_CS, u_lr=U_LR, u_beta1=U_BETA1,
             unet_params=np.array(unet_params, dtype=object),
             unet_state=np.array(unet_state, dtype=object),
             n_clean=np.stack([b[0] for b in n]), n_noisy=np.stack([b[1] for b in n]),
             n_loss_cs=N_LOSS_CS, n_lr=N_LR,
             d_ckpt=str(tmp / "discriminator_3.npz"), d_loss_cs=D_LOSS_CS,
             d_clean=np.stack([b[0] for b in d_batches]),
             d_generated=np.stack([b[1] for b in d_batches]),
             d_noisy=np.stack([b[2] for b in d_batches]),
             d_draws_real=np.stack([dr[0] for dr in draws]),
             d_draws_fake=np.stack([dr[1] for dr in draws]),
             d_learn_clean=learn_batch[0], d_learn_noisy=learn_batch[1],
             d_learn_draws_real=learn_draws[0], d_learn_draws_fake=learn_draws[1])
    return {"path": path, "utnet": utnet, "u": u, "unet": (unet_params, unet_state), "n": n,
            "jax_disc": d, "d_batches": d_batches, "d_keys": d_keys,
            "learn": (learn_batch, learn_key), "jgen": jgen}


def _jax_utnet(inp, accum):
    """Two JAX steps on the batch sharded over two devices: (losses, the
    port's state_dict of the trained params)."""
    mesh2 = jax_mesh.make_mesh(2)
    opt = jax_steps.make_optimizer(U_LR, U_BETA1)
    step = jax_steps.make_generator_train_step(
        partial(JaxUtNet.apply_fast, activation="PReLU"), opt, {"MSE": 1.0}, U_LOSS_CS,
        donate=False, grad_accum=accum)
    params = inp["utnet"]
    state = jax_steps.TrainState(jax_mesh.replicate_tree(mesh2, params),
                                 jax_mesh.replicate_tree(mesh2, opt.init(params)))
    losses, step = [], _fast(step)
    for clean, noisy in inp["u"]:
        state, m = step(state, *jax_mesh.shard_batch(mesh2, clean, noisy))
        losses.append(float(m["weighted"]))
    return losses, params_io.state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                        state.params))


def _jax_unet(inp):
    """Two JAX UNet steps under SGD on the sharded batch: (losses, the
    port's state_dict after each step)."""
    import optax

    mesh2 = jax_mesh.make_mesh(2)
    params, bn_state = inp["unet"]
    opt = optax.sgd(N_LR)
    step = jax_steps.make_generator_train_step(
        lambda p, x, ms: JaxUNet.apply(p, x, ms, train=True), opt, N_WEIGHTS, N_LOSS_CS,
        donate=False, stateful=True)
    state = jax_steps.TrainState(jax_mesh.replicate_tree(mesh2, params),
                                 jax_mesh.replicate_tree(mesh2, opt.init(params)),
                                 jax_mesh.replicate_tree(mesh2, bn_state))
    losses, states, step = [], [], _fast(step)
    for clean, noisy in inp["n"]:
        state, m = step(state, *jax_mesh.shard_batch(mesh2, clean, noisy))
        losses.append(float(m["weighted"]))
        states.append(params_io.unet_state_dict_from_jax(
            *(jax.tree_util.tree_map(np.asarray, t) for t in (state.params, state.model_state))))
    return losses, states


def _jax_disc_refs(inp):
    """The JAX wrapper's two steps on the sharded crops (fake targets clean,
    then noisy), its state after them, and its ``learn``'s loss."""
    mesh2 = jax_mesh.make_mesh(2)
    d = inp["jax_disc"]
    outs, step = [], _fast(d._unsharded_step)
    state = jax_mesh.replicate_tree(mesh2, d.state)
    for crops, key, noisy_t in zip(inp["d_batches"], inp["d_keys"], (False, True)):
        state, (lr_, lf_, ranges) = step(state, key, *jax_mesh.shard_batch(mesh2, *crops),
                                         jnp.asarray(noisy_t))
        outs.append(np.concatenate([[float(lr_), float(lf_)], np.asarray(ranges)]))
    d.state = state = jax.tree_util.tree_map(np.asarray, state)
    (clean, noisy), key = inp["learn"]
    d.loss = 0.2  # fake targets noisy
    d.learn(key, clean, noisy, inp["jgen"], loss_cs=D_LOSS_CS)
    return np.stack(outs), state, d.loss


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, cli_procs):
    """The two ranks of the ``steps`` child, and the JAX references computed
    while they and the command-line runs go on: (inputs, references, both
    ranks' outputs)."""
    tmp = tmp_path_factory.mktemp("dp")
    inp = _inputs(tmp)
    port = _free_port()
    procs = _start([[sys.executable, CHILD, "steps", f"127.0.0.1:{port}", str(r), inp["path"],
                     str(tmp)] for r in range(2)], [_env()] * 2)
    try:
        refs = {"utnet": {a: _jax_utnet(inp, a) for a in (1, 2)}, "unet": _jax_unet(inp),
                "disc": _jax_disc_refs(inp)}
    finally:
        _wait(procs)
    return inp, refs, [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=True))
                       for r in range(2)]


def _prefixed(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items() if k.startswith(prefix)}


def _both_ranks_equal(ranks, prefix):
    a, b = (_prefixed(r, prefix) for r in ranks)
    assert a.keys() == b.keys() and a
    for k in a:
        assert np.array_equal(a[k], b[k]), (prefix, k)
    return a


@pytest.mark.parametrize("accum", [1, 2])
def test_utnet_dp_steps_match_jax_on_a_sharded_batch(dp_run, accum):
    inp, refs, ranks = dp_run
    losses, ref = refs["utnet"][accum]
    got = _both_ranks_equal(ranks, f"utnet{accum}/")
    np.testing.assert_allclose(ranks[0][f"utnet{accum}_loss"], losses, rtol=0, atol=LOSS_TOL)
    start = params_io.state_dict_from_jax(inp["utnet"])
    assert max(float((ref[k] - start[k]).abs().max()) for k in ref) > 10 * ATOL
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


def test_unet_dp_steps_take_the_global_batch_statistics(dp_run):
    """Two steps under plain SGD on both sides: UNet's conv biases before
    each BatchNorm have a gradient that is 0 in exact arithmetic, which a
    fresh AMSGrad would turn into a step of about its learning rate in a
    direction set by rounding (tests/test_torch_unet.py). The running stats
    are held after the first step, from the same weights on both sides:
    JAX's fp32 UNet gradient lies about 2e-3 of its norm from a float64
    step (the port's DP one about 2e-6), so after the second step they
    also carry the first update's difference."""
    inp, refs, ranks = dp_run
    losses, states = refs["unet"]
    got = _both_ranks_equal(ranks, "unet/")
    got_stats = _both_ranks_equal(ranks, "unet_step1/")
    np.testing.assert_allclose(ranks[0]["unet_loss"], losses, rtol=0, atol=LOSS_TOL)
    start = params_io.unet_state_dict_from_jax(*inp["unet"])
    assert sorted(got_stats) == sorted(k for k in start
                                       if k.endswith(("running_mean", "running_var")))
    assert max(float((states[0][k] - start[k]).abs().max()) for k in got_stats) > 1e-3
    for k, v in got_stats.items():
        np.testing.assert_allclose(v, states[0][k].numpy(), rtol=0, atol=STATS_TOL, err_msg=k)
    ref = states[-1]
    weights = [k for k in ref if k.endswith(("weight", "bias"))]
    assert max(float((ref[k] - start[k]).abs().max()) for k in weights) > 10 * ATOL
    for k in weights:
        np.testing.assert_allclose(got[k], ref[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


def _disc_sd(params, state=None):
    tree = jax.tree_util.tree_map(np.asarray, params)
    st = None if state is None else jax.tree_util.tree_map(np.asarray, state)
    return params_io.hul_state_dict_from_jax(tree, st, "Hul112Disc")


def test_discriminator_dp_steps_match_jax(dp_run):
    """Two steps with JAX's uniform draws at the global shape: losses,
    ranges, parameters, BN state and Adam's moments after them; then one
    ``learn`` (its update is not held, as in tests/test_torch_gan.py):
    ``d.loss`` equal on both ranks and to JAX's, the ranks' networks
    bit-equal."""
    _, refs, ranks = dp_run
    steps_ref, state, loss_ref = refs["disc"]
    for r in ranks:
        np.testing.assert_allclose(r["d_steps"], steps_ref, rtol=0, atol=D_TOL)
    ck = ranks[0]["d_ckpt"].item()
    got, ref = _disc_sd(ck["params"], ck["state"]), _disc_sd(state.params, state.model_state)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=D_TOL,
                                   err_msg=k)
    n = len(params_io.leaf_paths(ck["params"]))
    inner = state.opt_state.inner_state[0]
    for j, ref_m in enumerate((inner.mu, inner.nu)):
        got_m = _disc_sd(params_io._unflatten_like(
            ck["params"], iter(ck["opt"][7 + j * n: 7 + (j + 1) * n])))
        ref_m = _disc_sd(ref_m)
        for k in ref_m:
            scale = float(ref_m[k].abs().max())
            assert float((got_m[k] - ref_m[k]).abs().max()) <= 1e-3 * scale, k
    losses = [float(r["d_learn_loss"]) for r in ranks]
    assert losses[0] == losses[1] and abs(losses[0] - loss_ref) <= D_TOL
    _both_ranks_equal(ranks, "d_learned/")


# -- the command line -------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp_cli")
    root = base / "SYN_192_176"
    rng = np.random.default_rng(5)
    for s in range(4):
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
    vy.write_text(yaml.safe_dump([[str(d / "ISO200" / f"SYN_scene0_ISO200_{x}_0_176.png"),
                                   str(d / "ISO3200" / f"SYN_scene0_ISO3200_{x}_0_176.png")]
                                  for x in (0, 176)]))
    init = str(base / "init.npz")
    fixtures.write_jax_checkpoint(init, 8, 0)
    args = ["--train_data", str(root), "--test_reserve", "0", "--g_network", "UtNet",
            "--g_funit", "8", "--g_model_path", init, "--cs", "168", "--loss_cs", "168",
            "--batch_size", "4", "--g_lr", "3e-5", "--beta1", "0.75", "--patience", "2",
            "--reduce_lr_factor", "0.5", "--min_lr", "1e-9", "--validation_set_yaml", str(vy),
            "--threads", "1", "--weight_D1", "0.2", "--d_lr", "1e-5", "--d_funit", "2",
            "--epochs", "3", "--device", "cpu"]
    return {"base": base, "args": args, "init": init}


def _loop_cmd(args):
    return [sys.executable, "-m", "nind_denoise_tpu_torch.train.loop", *args]


def _experiments(models):
    """(the chief's experiment directory, rank 1's)."""
    rank1 = [e for e in os.listdir(models) if e.endswith("_rank1")]
    chief = [e for e in os.listdir(models) if not e.endswith("_rank1")]
    assert len(chief) == 1 and len(rank1) <= 1, os.listdir(models)
    return chief + rank1


def _log(models, exp):
    with open(os.path.join(models, exp, "train.log")) as f:
        return f.read()


def _res(exp):
    with open(os.path.join(exp, "trainres.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cli_procs(cli_data):
    """All the command-line runs, started at once: one process; two ranks
    from torchrun's variables; two from JAX's three flags with
    ``--device_cache``; two with rank 1's shutdown flag raised before its
    second batch (``_torch_dp_child.py shutdown``). Each run's models
    directory and processes."""
    runs = {}
    args = cli_data["args"]
    for name in ("one", "torchrun", "flags", "shutdown"):
        models = str(cli_data["base"] / name)
        argv, port = args + ["--models_dpath", models], _free_port()
        if name == "one":
            cmds, envs = [_loop_cmd(argv)], [_env()]
        elif name == "torchrun":
            cmds = [_loop_cmd(argv)] * 2
            envs = [_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                         RANK=str(r), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2")
                    for r in range(2)]
        elif name == "flags":
            cmds = [_loop_cmd(argv + ["--device_cache", "8", "--coordinator",
                                      f"127.0.0.1:{port}", "--num_processes", "2",
                                      "--process_id", str(r)]) for r in range(2)]
            envs = [_env()] * 2
        else:
            cmds = [[sys.executable, CHILD, "shutdown", f"127.0.0.1:{port}", str(r), "2",
                     *argv] for r in range(2)]
            envs = [_env()] * 2
        runs[name] = (models, _start(cmds, envs))
    yield runs
    for _, procs in runs.values():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def cli_runs(cli_procs):
    """Each command-line run's models directory and its processes' outputs."""
    return {name: (models, _wait(procs)) for name, (models, procs) in cli_procs.items()}


def _schedule(text):
    """Each batch line's learners: (epoch, batch, D1 learned, G learned)."""
    return [(m[0], m[1], "loss D1" in m[2], "loss G" in m[2])
            for m in re.findall(r"Epoch (\d+) batch (\d+)/\d+: (.*)", text)]


@pytest.mark.parametrize("join", ["torchrun", "flags"])
def test_two_rank_cli_matches_one_process(cli_data, cli_runs, join):
    """Two ranks from torchrun's variables, and from JAX's three flags (with
    ``--device_cache``, which the DP predicate turns off): the chief's last
    checkpoint, ``trainres.json`` and the D/G schedule against one process;
    only the chief writes checkpoints; rank 1 logs to ``<expname>_rank1``."""
    models, _ = cli_runs[join]
    one_models, _ = cli_runs["one"]
    (one,) = (os.path.join(one_models, e) for e in os.listdir(one_models))
    chief, rank1 = _experiments(models)
    assert rank1 == chief[:249] + "_rank1"
    logs = [_log(models, e) for e in (chief, rank1)]
    for r, text in enumerate(logs):
        first = text.splitlines()[0]
        assert first.startswith("Data-parallel over 2 processes on gloo: rank "
                                f"{r} on cpu, 2 of each batch's 4 rows"), first
        assert ("data-parallel meshes keep the host loader" in text) == (join == "flags")
    digests = [re.findall(r"Data-parallel replica digest: (\w+)", t) for t in logs]
    assert digests[0] == digests[1] and len(digests[0]) == 2
    with open(os.path.join(one, "train.log")) as f:
        sched = _schedule(f.read())
    assert _schedule(logs[0]) == _schedule(logs[1]) == sched and len(sched) == 6
    assert any(s[2] for s in sched) and any(s[3] for s in sched)
    written = sorted(f for f in os.listdir(os.path.join(models, chief)) if f.endswith(".npz"))
    ref_written = sorted(f for f in os.listdir(one) if f.endswith(".npz"))
    assert written == ref_written and "generator_2.npz" in written
    assert not [f for f in os.listdir(os.path.join(models, rank1)) if f.endswith(".npz")]
    got, ref = _res(os.path.join(models, chief)), _res(one)
    assert _res(os.path.join(models, rank1)) == got
    assert got.keys() == ref.keys()
    for e in ref:
        if not isinstance(ref[e], dict):
            assert got[e] == ref[e], e
            continue
        assert got[e].keys() == ref[e].keys(), e
        for k, v in ref[e].items():
            assert abs(got[e][k] - v) <= 1e-6, (e, k, got[e][k], v)
    init = params_io.load_npz(cli_data["init"])
    for name in ("generator_2.npz", "discriminator_2.npz"):
        a = params_io.load_npz(os.path.join(models, chief, name))["params"]
        b = params_io.load_npz(os.path.join(one, name))["params"]
        paths = params_io.leaf_paths(b)
        assert params_io.leaf_paths(a) == paths and paths
        moved = 0.0
        for path in paths:
            la, lb = a, b
            for k in path:
                la, lb = la[k], lb[k]
            np.testing.assert_allclose(la, lb, rtol=RTOL, atol=ATOL, err_msg=f"{name} {path}")
            if name.startswith("generator"):
                li = init
                for k in path:
                    li = li[k]
                moved = max(moved, float(np.abs(lb - li).max()))
        assert name.startswith("disc") or moved > 5 * ATOL


def test_shutdown_on_one_rank_checkpoints_both_at_the_same_batch(cli_runs):
    """Rank 1 alone sees the shutdown flag, before its second batch: both
    ranks stop after batch 1 of epoch 1 and the chief checkpoints."""
    models, outs = cli_runs["shutdown"]
    chief, rank1 = _experiments(models)
    for exp, out in zip((chief, rank1), outs):
        assert f"EXPERIMENT {os.path.join(models, exp)}" in out
        assert "Graceful shutdown: checkpointing epoch 1 after 1/3 batches" in _log(models, exp)
    assert sorted(f for f in os.listdir(os.path.join(models, chief)) if f.endswith(".npz")) \
        == ["discriminator_1.npz", "generator_1.npz"]
    assert not [f for f in os.listdir(os.path.join(models, rank1)) if f.endswith(".npz")]


@pytest.mark.parametrize("extra,match", [
    (["--batch_size", "3"], "must be a multiple of 2"),
    (["--batch_size", "6", "--grad_accum", "2"], "must be a multiple of 4"),
])
def test_two_processes_with_an_unsplittable_batch_raise_before_writing(cli_data, tmp_path,
                                                                       extra, match):
    with pytest.raises(ValueError, match=match):
        loop.main(cli_data["args"] + ["--models_dpath", str(tmp_path), "--num_processes", "2",
                                      "--process_id", "0", "--coordinator", "127.0.0.1:1"]
                  + extra)
    assert not os.listdir(tmp_path)


def test_the_predicate_and_the_rank_rows():
    assert not data_parallel.enabled(1, 4)
    assert data_parallel.enabled(2, 4) and not data_parallel.enabled(2, 6, 2)
    assert data_parallel.enabled(2, 8, 2) and not data_parallel.enabled(3, 4)
    # rank r takes the r-th part of each of JAX's contiguous microbatches
    assert data_parallel.rank_rows(8, 2, 0, 2) == [0, 1, 4, 5]
    assert data_parallel.rank_rows(8, 2, 1, 2) == [2, 3, 6, 7]
    rows = sorted(r for k in range(4) for r in data_parallel.rank_rows(12, 4, k, 3))
    assert rows == list(range(12))


def test_global_batch_norm_without_a_run_is_torchs():
    """Outside a data-parallel run the converted module and the function
    are ``nn.BatchNorm2d`` and ``F.batch_norm``, bit for bit."""
    torch.manual_seed(0)
    x = torch.randn(3, 4, 5, 6)
    a, b = torch.nn.BatchNorm2d(4), torch.nn.BatchNorm2d(4)
    assert data_parallel.convert_batch_norm(torch.nn.Sequential(b)) == 1
    assert isinstance(b, data_parallel.GlobalBatchNorm2d)
    assert torch.equal(a(x), b(x))
    for k, v in a.state_dict().items():
        assert torch.equal(b.state_dict()[k], v), k

