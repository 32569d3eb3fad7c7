"""The port's product CLI against the JAX CLI on one 16-bit TIFF, the
package boundary (no jax, no nind_denoise_tpu) and the device rule."""

import os
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax

from nind_denoise_tpu.models import params_io as jax_params_io
from nind_denoise_tpu.models.utnet import UtNet as JaxUtNet
from nind_denoise_tpu.pipeline import denoise_cli as jax_cli
from nind_denoise_tpu_torch.pipeline import denoise_cli as port_cli
from nind_denoise_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def checkpoint(tmp_path):
    params = JaxUtNet.init(jax.random.PRNGKey(0), funit=8)
    path = str(tmp_path / "models" / "utnet" / "generator_1.npz")
    jax_params_io.save(params, path)
    return path


def _capture(monkeypatch, module):
    """Record the uint8 image each CLI hands to its encoder."""
    seen = []
    encode = module._encode_u8

    def spy(u8, out_fpath, quality):
        seen.append(np.array(u8))
        encode(u8, out_fpath, quality)

    monkeypatch.setattr(module, "_encode_u8", spy)
    return seen


def test_cli_tiff_input_matches_jax(tmp_path, checkpoint, monkeypatch):
    img = (np.random.default_rng(0).random((150, 170, 3)) * 65535).astype(np.uint16)
    tif = tmp_path / "img.tif"
    cv2.imwrite(str(tif), img)
    common = [str(tif), "--tiff-input", "--model_path", checkpoint,
              "--cs", "104", "--ucs", "88", "--batch_size", "2",
              "--compute_dtype", "float32", "-q", "95"]
    jax_seen, port_seen = _capture(monkeypatch, jax_cli), _capture(monkeypatch, port_cli)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_cli.main(common + ["-o", str(tmp_path / "jax")])
    out = port_cli.main(common + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert out == tmp_path / "port" / "img.jpg" and out.is_file()
    assert cv2.imread(str(out)).shape == (150, 170, 3)
    (ref,), (got,) = jax_seen, port_seen
    assert got.shape == ref.shape == (150, 170, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    # a second run resolves the name collision like the reference
    again = port_cli.main(common + ["-o", str(tmp_path / "port"), "--device", "cpu",
                                    "--no_deblur"])
    assert again == tmp_path / "port" / "img_1.jpg" and again.is_file()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = r"""
import importlib, pkgutil, sys
import nind_denoise_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "nind_denoise_tpu" or m.startswith("nind_denoise_tpu."))
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_entry_points_without_a_device_raise_when_cuda_is_absent(
        tmp_path, checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    tif = tmp_path / "img.tif"
    cv2.imwrite(str(tif), np.zeros((64, 64, 3), np.uint16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main([str(tif), "--tiff-input", "--model_path", checkpoint,
                       "-o", str(tmp_path)])
    assert not (tmp_path / "img.jpg").exists()


@pytest.mark.parametrize("hw", [(150, 170), (40, 50)])  # tiled, tiny-image path
def test_image_cli_matches_jax(tmp_path, checkpoint, hw):
    from nind_denoise_tpu.pipeline import denoise_image_cli as jax_image_cli
    from nind_denoise_tpu_torch.pipeline import denoise_image_cli as port_image_cli

    img = (np.random.default_rng(1).random((*hw, 3)) * 65535).astype(np.uint16)
    src = tmp_path / "in.png"
    cv2.imwrite(str(src), img)
    common = ["-i", str(src), "--network", "UtNet", "--model_path", checkpoint,
              "--cs", "104", "--ucs", "88", "-b", "2", "--compute_dtype", "float32",
              "--precision", "float32", "--exif_method", "noexif"]
    jax_image_cli.main(common + ["-o", str(tmp_path / "jax.tif"), "--devices", "1"])
    port_image_cli.main(common + ["-o", str(tmp_path / "port.tif"), "--device", "cpu"])
    ref = cv2.imread(str(tmp_path / "jax.tif"), cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tmp_path / "port.tif"), cv2.IMREAD_UNCHANGED)
    assert got.dtype == ref.dtype == np.uint16 and got.shape == ref.shape == (*hw, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
