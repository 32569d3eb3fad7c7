"""The port's trainer command line (``train/loop.py``) against the JAX
trainer's, and checkpoints that cross between them.

Both CLIs train two epochs of UtNet funit 4 from one ``--g_model_path``
file on seeded synthetic crops in the NIND layout (192 px crops, 168 px
random crops, MS-SSIM on all 168 px), with one loader thread, an MSE
warm-up epoch and a quarter of each batch from a clean-image directory;
the port sums its metrics on the device (``--log_interval 2``). Then each
resumes for one epoch from the other's last checkpoint.

Tolerance: ``trainres.json``'s losses 2e-5 absolute (seen: 2e-6, the
MS-SSIM windows' summation order, over a few steps), ``gen_lr`` equal.
"""

import json
import os
import signal

import cv2
import numpy as np
import pytest
import torch
import yaml
from scipy.ndimage import gaussian_filter

from nind_denoise_tpu.models import params_io as jax_params_io
from nind_denoise_tpu.train import loop as jax_loop
from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.tools.fixtures import write_jax_checkpoint
from nind_denoise_tpu_torch.train import dataset as ds_mod
from nind_denoise_tpu_torch.train import loop

TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch's default threads under the fast tier's parallel workers
    oversubscribe the host: two a worker, as test_torch_train_gan_cli.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("train")
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
    clean_dir = base / "clean"
    clean_dir.mkdir()
    for i in range(3):
        img = gaussian_filter(rng.random((180, 200, 3)), (2, 2, 0))
        cv2.imwrite(str(clean_dir / f"c{i}.png"), (img * 255).astype(np.uint8))
    d = root / "scene0"
    val = [[str(d / "ISO200" / f"SYN_scene0_ISO200_{x}_0_176.png"),
            str(d / "ISO3200" / f"SYN_scene0_ISO3200_{x}_0_176.png")] for x in (0, 176)]
    vy = base / "val.yaml"
    vy.write_text(yaml.safe_dump(val))
    init = str(base / "init.npz")
    write_jax_checkpoint(init, 4, 0)
    args = ["--train_data", str(root), "--test_reserve", "0",
            "--g_network", "UtNet", "--g_funit", "4", "--cs", "168",
            "--loss_cs", "168", "--batch_size", "4", "--g_lr", "3e-4",
            "--beta1", "0.75", "--patience", "2", "--reduce_lr_factor", "0.5",
            "--min_lr", "1e-9", "--validation_set_yaml", str(vy), "--threads", "1"]
    return {"base": base, "args": args, "init": init, "clean": str(clean_dir)}


def _first_run_args(data):
    return data["args"] + ["--g_model_path", data["init"], "--epochs", "3",
                           "--msssim_warmup_epochs", "1",
                           "--clean_data_dpath", data["clean"],
                           "--clean_data_ratio", "0.25"]


def _run_jax(argv, models):
    jax_loop.main(argv + ["--models_dpath", models])
    (exp,) = os.listdir(models)
    return os.path.join(models, exp)


def _res(exp):
    with open(os.path.join(exp, "trainres.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def first_runs(data):
    argv = _first_run_args(data)
    jax_exp = _run_jax(argv, str(data["base"] / "jax"))
    port_exp = loop.main(argv + ["--models_dpath", str(data["base"] / "port"),
                                 "--device", "cpu", "--log_interval", "2"])
    return jax_exp, port_exp


def _assert_epochs_match(ref, got, epochs):
    for e in epochs:
        r, g = ref[str(e)], got[str(e)]
        assert set(r) == set(g), e
        for k in ("train_weighted_loss", "validation_loss"):
            if k in r:
                assert abs(r[k] - g[k]) < TOL, (e, k, r[k], g[k])
        assert r.get("gen_lr") == g.get("gen_lr")


def test_two_epochs_match_the_jax_cli(first_runs):
    jax_exp, port_exp = first_runs
    ref, got = _res(jax_exp), _res(port_exp)
    _assert_epochs_match(ref, got, (0, 1, 2))
    assert ref["best_epoch"] == got["best_epoch"]
    assert 0 < got["2"]["train_weighted_loss"] < 1
    assert set(os.listdir(port_exp)) == set(os.listdir(jax_exp))
    with open(os.path.join(port_exp, "config.yaml")) as f:
        port_cfg = yaml.safe_load(f)
    with open(os.path.join(jax_exp, "config.yaml")) as f:
        jax_cfg = yaml.safe_load(f)
    assert set(jax_cfg) <= set(port_cfg)
    log = open(os.path.join(port_exp, "train.log")).read()
    assert "Epoch 2 summary:" in log and "Validation loss:" in log


def test_port_checkpoint_loads_in_jax(first_runs):
    _, port_exp = first_runs
    tree = jax_params_io.load(os.path.join(port_exp, "generator_2.npz"))
    assert tree["epoch"] == 2 and tree["state"] is None
    opt = jax_steps.make_optimizer(3e-4, 0.75)
    restored = jax_steps.restore_opt_state(opt, tree["params"], tree["opt"])
    assert int(restored.count) == int(restored.inner_state[0].count) == 2 * 2
    assert float(restored.hyperparams["b1"]) == 0.75
    model = params_io.load_generator(os.path.join(port_exp, "generator_2.npz"))
    assert params_io.UtNet.funit_of(model.state_dict()) == 4


def test_each_cli_resumes_from_the_others_checkpoint(data, first_runs):
    jax_exp, port_exp = first_runs
    argv = data["args"] + ["--epochs", "4"]
    jax_from_port = _run_jax(argv + ["--g_model_path",
                                     os.path.join(port_exp, "generator_2.npz")],
                             str(data["base"] / "jax_resumed"))
    port_from_jax = loop.main(argv + ["--g_model_path",
                                      os.path.join(jax_exp, "generator_2.npz"),
                                      "--models_dpath", str(data["base"] / "port_resumed"),
                                      "--device", "cpu"])
    ref, got = _res(jax_from_port), _res(port_from_jax)
    assert "1" not in got and "2" not in got and "3" in got
    _assert_epochs_match(ref, got, (0, 3))
    log = open(os.path.join(port_from_jax, "train.log")).read()
    assert "Restored optimizer state (resume from epoch 2)" in log
    assert "Resuming at epoch 3" in log


def test_graceful_shutdown_checkpoints_and_resumes(data, tmp_path, monkeypatch):
    """SIGTERM during the first epoch: the step in flight finishes, the
    epoch is checkpointed with its optimizer state, main returns, and the
    previous signal handlers are back. Also drives bf16, remat,
    grad_accum and the validation image dumps through the CLI."""
    iterate = ds_mod.Loader.__iter__

    def iter_then_signal(self):
        for k, batch in enumerate(iterate(self)):
            if k == 1:
                signal.raise_signal(signal.SIGTERM)
            yield batch

    monkeypatch.setattr(ds_mod.Loader, "__iter__", iter_then_signal)
    prev = signal.getsignal(signal.SIGTERM)
    exp = loop.main(data["args"] + [
        "--g_model_path", data["init"], "--epochs", "3", "--batch_size", "2",
        "--models_dpath", str(tmp_path), "--device", "cpu",
        "--compute_dtype", "bfloat16", "--remat", "--grad_accum", "2"])
    assert signal.getsignal(signal.SIGTERM) == prev
    assert sorted(f for f in os.listdir(exp) if f.endswith(".npz")) == ["generator_1.npz"]
    tree = params_io.load_npz(os.path.join(exp, "generator_1.npz"))
    assert tree["epoch"] == 1 and int(tree["opt"][0]) == 1
    log = open(os.path.join(exp, "train.log")).read()
    assert "Graceful shutdown: checkpointing epoch 1 after 1/3 batches" in log
    resume = os.path.join(exp, "generator_1.npz")
    assert "--g_model_path " + resume in log
    monkeypatch.setattr(ds_mod.Loader, "__iter__", iterate)
    again = loop.main(data["args"] + [
        "--g_model_path", resume, "--epochs", "3", "--batch_size", "2",
        "--models_dpath", str(tmp_path / "resumed"), "--device", "cpu",
        "--compute_dtype", "bfloat16", "--debug_options", "output_val_images"])
    res = _res(again)
    assert "1" not in res and 0 < res["2"]["train_weighted_loss"] < 1
    assert sorted(os.listdir(os.path.join(again, "val", "2"))) == ["0.tif", "1.tif"]
    assert int(params_io.load_npz(os.path.join(again, "generator_2.npz"))["opt"][0]) == 1 + 3


def test_delete_outperformed_models_matches_jax(tmp_path):
    def tree(d):
        d.mkdir()
        for e in (1, 2, 3):
            (d / f"generator_{e}.npz").write_bytes(b"x")
            (d / "val" / str(e)).mkdir(parents=True)
        (d / "trainres.json").write_text("{}")
        (d / "discriminator_1.npz").write_bytes(b"x")
        return d

    for keep_all in (False, True):
        a, b = tree(tmp_path / f"jax{keep_all}"), tree(tmp_path / f"port{keep_all}")
        ra = jax_loop.delete_outperformed_models(str(a), {2}, keep_all_output_images=keep_all)
        rb = loop.delete_outperformed_models(str(b), {2}, keep_all_output_images=keep_all)
        assert sorted(os.path.relpath(p, a) for p in ra) == \
            sorted(os.path.relpath(p, b) for p in rb)
        assert sorted(os.listdir(b)) == ["discriminator_1.npz", "generator_2.npz",
                                         "trainres.json", "val"]
        assert sorted(os.listdir(b / "val")) == (["1", "2", "3"] if keep_all else ["2"])


def test_test_reserve_list_matches_jax(tmp_path):
    y = tmp_path / "r.yaml"
    y.write_text(yaml.safe_dump(["a", "b"]))
    for arg in ([str(y)], ["0"], ["x", "y"], None):
        assert loop.get_test_reserve_list(arg) == jax_loop.get_test_reserve_list(arg)


@pytest.mark.parametrize("extra,exc,match", [
    # the pix2pix critics run conditional (tests/test_torch_p2p.py); unconditional
    # they cannot run in either package, and the multiscale one gives a list
    (["--weight_D1", "0.5", "--d_lr", "1e-4", "--d_network", "NLayerDiscriminator",
      "--not_conditional"], ValueError, "take 6 channels"),
    (["--weight_D2", "1", "--d2_lr", "1e-4", "--d2_network", "PixelDiscriminator",
      "--not_conditional_2"], ValueError, "take 6 channels"),
    (["--weight_D1", "0.5", "--d_lr", "1e-4", "--d_network", "MultiscaleDiscriminator"],
     ValueError, "one prediction map per scale"),
    (["--g_network", "DnCNN"], SystemExit, "registry/inference-only"),
    # the relic critics run (tests/test_torch_relics.py), but HunkyDisc's
    # prediction map is empty below 256 px, here at loss_cs 168
    (["--weight_D1", "0.5", "--d_lr", "1e-4", "--d_network", "HunkyDisc"],
     ValueError, "prediction map is empty"),
])
def test_unported_flags_raise_naming_their_roadmap_item(data, tmp_path, extra, exc, match):
    """Refused before anything is written: what cannot run in either
    package says why (the three multi-process flags run since data-parallel
    training landed: tests/test_torch_train_dp.py)."""
    with pytest.raises(exc, match=match):
        loop.main(data["args"] + ["--models_dpath", str(tmp_path), "--device", "cpu"]
                  + extra)
    assert not os.listdir(tmp_path)


def test_no_device_means_cuda_and_raises_without_it(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.main(data["args"] + ["--models_dpath", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_missing_lr_and_bad_grad_accum_exit(data, tmp_path):
    args = [a for a in data["args"]]
    i = args.index("--g_lr")
    del args[i:i + 2]
    with pytest.raises(SystemExit, match="g_lr is required"):
        loop.main(args + ["--models_dpath", str(tmp_path / "a"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="must divide"):
        loop.main(data["args"] + ["--models_dpath", str(tmp_path / "b"), "--device", "cpu",
                                  "--grad_accum", "3"])
    with pytest.raises(SystemExit, match="d_lr/--d2_lr are required"):
        loop.main(data["args"] + ["--models_dpath", str(tmp_path / "c"), "--device", "cpu",
                                  "--weight_D2", "0.5"])


def test_async_checkpointer_snapshots_and_propagates_errors(tmp_path):
    ck = loop.AsyncCheckpointer()
    live = torch.arange(4.0)
    fpath = str(tmp_path / "ck.npz")
    ck.submit(lambda t: params_io.save({"w": t["w"].numpy(), "epoch": t["epoch"]}, fpath),
              {"w": live, "epoch": 3})
    live += 100  # the snapshot was taken at submit
    ck.join()
    got = jax_params_io.load(fpath)
    np.testing.assert_array_equal(got["w"], np.arange(4.0))
    assert got["epoch"] == 3

    def boom(_):
        raise OSError("disk full")

    ck.submit(boom, {"w": live})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.join()
    ck.join()
