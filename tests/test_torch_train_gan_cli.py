"""The port's trainer command line in its cGAN and device-cache modes,
on the CPU, port only (a JAX cGAN CLI run takes minutes; the steps and
checkpoints are held against JAX in tests/test_torch_gan.py).

UtNet funit 4 from one seeded checkpoint on seeded synthetic crops in the
NIND layout (192 px, 168 px random crops, MS-SSIM), batch 2, one loader
thread, Hul discriminators at funit 1. Torch runs on two threads here:
the runs are small, and under parallel test workers torch's default of
one thread per core oversubscribes the machine.
"""

import json
import os
import random
import re

import cv2
import numpy as np
import pytest
import torch
import yaml
from scipy.ndimage import gaussian_filter

from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.tools.fixtures import write_jax_checkpoint
from nind_denoise_tpu_torch.train import device_cache
from nind_denoise_tpu_torch.train import loop


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("gan_cli")
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
    vy = base / "val.yaml"
    vy.write_text(yaml.safe_dump([[str(d / "ISO200" / f"SYN_scene0_ISO200_{x}_0_176.png"),
                                   str(d / "ISO3200" / f"SYN_scene0_ISO3200_{x}_0_176.png")]
                                  for x in (0, 176)]))
    init = str(base / "init.npz")
    write_jax_checkpoint(init, 4, 0)
    args = ["--train_data", str(root), "--test_reserve", "0",
            "--g_network", "UtNet", "--g_funit", "4", "--cs", "168",
            "--loss_cs", "168", "--batch_size", "4", "--g_lr", "3e-4",
            "--beta1", "0.75", "--patience", "2", "--reduce_lr_factor", "0.5",
            "--min_lr", "1e-9", "--validation_set_yaml", str(vy), "--threads", "1"]
    return {"args": args, "init": init, "clean": str(clean_dir)}


def _res(exp):
    with open(os.path.join(exp, "trainres.json")) as f:
        return json.load(f)


def _batch_lines(exp):
    with open(os.path.join(exp, "train.log")) as f:
        return [ln for ln in f.read().splitlines() if re.match(r"Epoch \d+ batch \d+/", ln)]


GAN = ["--batch_size", "2", "--d_funit", "1", "--d2_funit", "1", "--d_lr", "1e-4",
       "--d2_lr", "2e-4", "--device", "cpu"]


def test_cgan_run_follows_the_schedule_and_resumes(data, tmp_path):
    """Two epochs with D1 (Hul112Disc, funit 1, conditional) and an
    advantage: each batch's logged D/G decisions are those of a replay of
    ``random.Random(seed)`` on the logged losses, drawn in the JAX loop's
    order; the discriminator checkpoints every epoch; a resume from both
    checkpoints carries Adam's count and the plateau scheduler."""
    exp = loop.main(data["args"] + GAN + [
        "--g_model_path", data["init"], "--epochs", "3", "--weight_D1", "0.2",
        "--discriminator_advantage", "0.1", "--models_dpath", str(tmp_path / "a")])
    lines = _batch_lines(exp)
    assert len(lines) == 6
    rng, d_loss, g_count, d_count = random.Random(123), 1.0, 0, 0
    for ln in lines:
        learns = d_loss + 0.1 > rng.random()
        assert learns == ("loss D1: " in ln), ln
        if learns:
            d_loss = float(re.search(r"loss D1: ([0-9.]+) \(", ln).group(1))
            d_count += 1
        g_learns = not learns or d_loss + 0.1 < rng.random()
        assert g_learns == ("loss G: " in ln), ln
        g_count += g_learns
    assert 0 < g_count < 6 and d_count > 0
    assert "D1: " in next(ln for ln in lines if "loss G: " in ln).split("loss G: ")[1]
    files = sorted(os.listdir(exp))
    assert {"discriminator_1.npz", "discriminator_2.npz"} <= set(files)
    log = open(os.path.join(exp, "train.log")).read()
    assert "Discriminator1 average normalized loss: " in log
    tree = params_io.load_npz(os.path.join(exp, "discriminator_2.npz"))
    assert int(tree["opt"][0]) == d_count and tree["sched"]["num_bad"] == 0

    again = loop.main(data["args"] + GAN + [
        "--g_model_path", os.path.join(exp, "generator_2.npz"), "--epochs", "4",
        "--weight_D1", "0.2", "--d_model_path", os.path.join(exp, "discriminator_2.npz"),
        "--models_dpath", str(tmp_path / "b")])
    log = open(os.path.join(again, "train.log")).read()
    assert "Resuming at epoch 3" in log and "Epoch 3 batch 3/3" in log
    d3 = params_io.load_npz(os.path.join(again, "discriminator_3.npz"))
    learned = sum("loss D1: " in ln for ln in _batch_lines(again))
    assert int(d3["opt"][0]) == d_count + learned
    assert d3["sched"]["best"] <= tree["sched"]["best"] or d3["sched"]["num_bad"] == 1


def test_d2_only_run_checkpoints_as_discriminator2(data, tmp_path):
    exp = loop.main(data["args"] + GAN + [
        "--g_model_path", data["init"], "--epochs", "2", "--weight_D2", "0.3",
        "--d2_network", "Hulb112Disc", "--models_dpath", str(tmp_path)])
    lines = _batch_lines(exp)
    assert any("loss D2: " in ln for ln in lines)
    assert not any("loss D1" in ln for ln in lines)
    g_lines = [ln for ln in lines if "loss G: " in ln]
    assert all("D2: " in ln.split("loss G: ")[1] for ln in g_lines)
    files = os.listdir(exp)
    assert "discriminator2_1.npz" in files
    assert not any(f.startswith("discriminator_") for f in files)
    tree = params_io.load_npz(os.path.join(exp, "discriminator2_1.npz"))
    assert tree["sched"]["lr"] == 2e-4
    assert all(st is None for b in tree["state"].values() for st in b)  # no BN


def test_freeze_generator_trains_the_discriminator_alone(data, tmp_path):
    """``--freeze_generator``: every batch trains the discriminator; the
    generator stays frozen while its loss is above 0.33, learns nothing
    and saves nothing."""
    exp = loop.main(data["args"] + GAN + [
        "--g_model_path", data["init"], "--epochs", "2", "--weight_D1", "0.2",
        "--freeze_generator", "--models_dpath", str(tmp_path)])
    lines = _batch_lines(exp)
    assert len(lines) == 3
    assert all("loss D1: " in ln and "loss G" not in ln for ln in lines)
    assert all(float(re.search(r"loss D1: ([0-9.]+)", ln).group(1)) > 0.33 for ln in lines)
    log = open(os.path.join(exp, "train.log")).read()
    assert "Generator learned nothing" in log
    files = os.listdir(exp)
    assert "discriminator_1.npz" in files and not any(f.startswith("generator_") for f in files)


def test_device_cache_run_and_its_host_loader_fallback(data, tmp_path):
    """``--device_cache``: the epochs draw from the cache (fill, refresh and
    swap at each boundary); with ``--clean_data_ratio`` the trainer warns
    and keeps the host loader, as the JAX trainer does."""
    swaps = []
    orig = device_cache.DeviceEpochCache.maybe_swap

    def spy(self):
        swaps.append(orig(self))
        return swaps[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(device_cache.DeviceEpochCache, "maybe_swap", spy)
    try:
        exp = loop.main(data["args"] + [
            "--g_model_path", data["init"], "--epochs", "3", "--device_cache", "4",
            "--device_cache_refresh", "0.5", "--batch_size", "2", "--device", "cpu",
            "--models_dpath", str(tmp_path / "a")])
    finally:
        mp.undo()
    log = open(os.path.join(exp, "train.log")).read()
    assert "Device cache: 4 crop pairs on the device" in log
    assert "Epoch 2 batch 2/2" in log and len(swaps) == 2
    res = _res(exp)
    assert 0 < res["2"]["train_weighted_loss"] < 1
    exp = loop.main(data["args"] + [
        "--g_model_path", data["init"], "--clean_data_dpath", data["clean"],
        "--clean_data_ratio", "0.25", "--device_cache", "4", "--device", "cpu",
        "--epochs", "2", "--models_dpath", str(tmp_path / "b")])
    log = open(os.path.join(exp, "train.log")).read()
    assert "--device_cache is incompatible with --clean_data_ratio" in log
    assert "Device cache:" not in log
