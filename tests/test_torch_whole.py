"""The port's whole-image mode and --debug tile dumps against the JAX
TileEngine's, both in fp32 on the CPU: ``denoise_whole`` at a size UtNet
takes and one it does not, with and without the side mirror (atol 5e-5,
the engine's bar), and the debug dumps' file names and pixels (1 LSB)."""

import os

import cv2
import numpy as np
import pytest

from nind_denoise_tpu.engine import tile_engine as jte
from nind_denoise_tpu.models import params_io as jax_params_io
from nind_denoise_tpu_torch.core import tiles
from nind_denoise_tpu_torch.engine import tile_engine as tte
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.tools.fixtures import write_jax_checkpoint

CS, UCS = 104, 88
ATOL, RTOL = 5e-5, 1e-4  # fp32, as tests/test_torch_engine.py


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "generator_1.npz")
    write_jax_checkpoint(path, 8, seed=12)
    return jax_params_io.load(path), params_io.load_generator(path)


def _engines(weights, **kw):
    kw = dict(cs=CS, ucs=UCS, batch_size=2, compute_dtype="float32",
              precision="float32", **kw)
    return (jte.make_engine("UtNet", weights[0], **kw),
            tte.make_engine("UtNet", weights[1], device="cpu", **kw))


@pytest.mark.parametrize("pad", [0, 8])
@pytest.mark.parametrize("hw", [(104, 136), (90, 117)])  # valid for UtNet, invalid
def test_denoise_whole_matches_jax(weights, hw, pad):
    jax_eng, port_eng = _engines(weights)
    img = np.random.default_rng(hw[1] + pad).random((3, *hw), dtype=np.float32)
    ref = jax_eng.denoise_whole(img, pad=pad)
    got = port_eng.denoise_whole(img, pad=pad)
    assert got.shape == ref.shape == img.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_whole_image_pad_is_the_jax_one():
    from nind_denoise_tpu.core import tiles as jax_tiles

    img = np.random.default_rng(0).random((3, 20, 30), dtype=np.float32)
    for pad in (0, 1, 8):
        np.testing.assert_array_equal(tiles.whole_image_pad(img, pad),
                                      jax_tiles.whole_image_pad(img, pad))


def test_debug_dumps_match_jax(weights, tmp_path, monkeypatch):
    """Each tile's noisy input and denoised output, under the JAX engine's
    file names, with pixels (captured before the JPEG encode) within 1 LSB."""
    written = {}
    imwrite = cv2.imwrite

    def spy(path, img, *a):
        written[path] = np.array(img)
        return imwrite(path, img, *a)

    monkeypatch.setattr(cv2, "imwrite", spy)
    raw = (np.random.default_rng(5).random((150, 170, 3)) * 65535).astype(np.uint16)
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    jax_eng, port_eng = _engines(weights)
    jax_eng.debug_dir, port_eng.debug_dir = dirs["jax"], dirs["port"]
    jax_eng.denoise_raw(raw, 65535.0)
    port_eng.denoise_raw(raw, 65535.0)
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"]))
    assert len(names) == 2 * 4 and "crop1_1_denoised.jpg" in names  # 2 x 2 tiles
    for name in names:
        ref = written[os.path.join(dirs["jax"], name)]
        got = written[os.path.join(dirs["port"], name)]
        assert got.shape == ref.shape == (CS, CS, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, name


@pytest.mark.parametrize("mode", ["whole", "debug_models_dpath"])
def test_image_cli_matches_jax(tmp_path, monkeypatch, mode):
    """denoise_image through both CLIs: --whole_image --pad 8 to a 16-bit
    TIFF; and --debug with the checkpoint named by its run directory under
    --models_dpath, to the default output path, dumping into dbg/."""
    from nind_denoise_tpu.pipeline import denoise_image_cli as jax_cli
    from nind_denoise_tpu_torch.pipeline import denoise_image_cli as port_cli

    models = tmp_path / "models"
    os.makedirs(models / "run")
    write_jax_checkpoint(str(models / "run" / "generator_3.npz"), 8, seed=13)
    img = (np.random.default_rng(7).random((90, 117, 3)) * 65535).astype(np.uint16)
    src = tmp_path / "in.png"
    cv2.imwrite(str(src), img)
    common = ["-i", str(src), "--network", "UtNet", "--cs", "104", "--ucs", "88",
              "-b", "2", "--compute_dtype", "float32", "--precision", "float32",
              "--exif_method", "noexif"]
    if mode == "whole":
        common += ["--whole_image", "--pad", "8", "--model_path",
                   str(models / "run" / "generator_3.npz")]
    else:
        common += ["--debug", "--model_path", "run", "--models_dpath", str(models)]
    outs = {}
    for side, cli, extra in (("jax", jax_cli, ["--devices", "1"]),
                             ("port", port_cli, ["--device", "cpu"])):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        argv = common + (["-o", "out.tif"] if mode == "whole" else [])
        outs[side] = cli.main(argv + extra)
    ref_path = os.path.join("test", "denoised_images", "in.png_run.tif") \
        if mode != "whole" else "out.tif"
    assert outs["port"] == ref_path
    ref = cv2.imread(str(tmp_path / "jax" / ref_path), cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tmp_path / "port" / ref_path), cv2.IMREAD_UNCHANGED)
    assert got.dtype == ref.dtype == np.uint16 and got.shape == ref.shape == (90, 117, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    if mode != "whole":
        names = sorted(os.listdir(tmp_path / "port" / "dbg"))
        assert names == sorted(os.listdir(tmp_path / "jax" / "dbg")) and len(names) == 8
