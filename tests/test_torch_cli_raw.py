"""The port's product CLI on its darktable paths against the JAX CLI, with
the same stand-ins for darktable-cli and gmic (tools/fixtures.py), fp32 on
the CPU (``--compute_dtype float32``): RAW input, --tiff-input with a
sidecar (stage 2 runs), --use-gmic, --debug with --nightmode (the kept
intermediates), --no_deblur, --copy_num and a RAW without a sidecar. The
pre-encode uint8 images agree within 1 LSB and the stand-ins' command lines
are equal. Then the port alone: a failed checkpoint fetch or a missing
darktable raises, networks the engine does not run raise, ``--devices 2``
runs, and a directory loads its checkpoint once with every output equal to
its own single run."""

import json
import os
import xml.etree.ElementTree as ET

import cv2
import numpy as np
import pytest
import torch

from nind_denoise_tpu.ops import rl_deblur as jax_rl
from nind_denoise_tpu.pipeline import denoise_cli as jax_cli
from nind_denoise_tpu.pipeline import denoise_image_cli as jax_image_cli
from nind_denoise_tpu_torch.engine import tile_engine as port_engine
from nind_denoise_tpu_torch.pipeline import denoise_cli as port_cli
from nind_denoise_tpu_torch.pipeline import denoise_image_cli as port_image_cli
from nind_denoise_tpu_torch.tools import fixtures
from test_pipeline import SIDECAR
from test_torch_xmp import _assert_same_tree

H, W = 120, 140
COMMON = ["--cs", "104", "--ucs", "88", "--batch_size", "2",
          "--compute_dtype", "float32", "-q", "95"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch's default threads under the fast tier's parallel workers
    oversubscribe the host: two a worker, as test_torch_train_gan_cli.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "generator_1.npz")
    fixtures.write_jax_checkpoint(path, 8, seed=21)
    return path


def _capture(monkeypatch):
    """The uint8 images each CLI encodes: the JAX CLI through its encoder
    (in-memory path) and its host RL (file path), the port through its
    encoder (both paths)."""
    seen = {"jax": [], "port": []}
    for side, mod in (("jax", jax_cli), ("port", port_cli)):
        encode = mod._encode_u8

        def spy(u8, path, quality, _side=side, _encode=encode):
            seen[_side].append(np.array(u8))
            _encode(u8, path, quality)

        monkeypatch.setattr(mod, "_encode_u8", spy)
    to_u8 = jax_rl.rl_deblur_to_uint8

    def rl_spy(*a, **kw):
        u8 = to_u8(*a, **kw)
        seen["jax"].append(np.array(u8))
        return u8

    monkeypatch.setattr(jax_rl, "rl_deblur_to_uint8", rl_spy)
    # the JAX image CLI on one device (the test mesh has eight)
    monkeypatch.setattr(jax_image_cli, "_resolve_devices", lambda args: 1)
    return seen


def _tiff(path, seed=0, hw=(H, W)):
    img = (np.random.default_rng(seed).random((*hw, 3)) * 65535).astype(np.uint16)
    assert cv2.imwrite(str(path), img)
    return path


CASES = {  # name -> (input file, sidecar name or None, extra argv)
    "raw": ("img.nef", "img.nef.xmp", ["--height", "120"]),
    "tiff_sidecar": ("img.tif", "img.tif.xmp", ["--tiff-input"]),
    "use_gmic": ("img.nef", "img.nef.xmp", ["--use-gmic"]),
    "debug_nightmode": ("img.nef", "img.nef.xmp", ["--debug", "--nightmode"]),
    "no_deblur": ("img.nef", "img.nef.xmp", ["--no_deblur"]),
    "copy_num": ("img.nef", "img_02.nef.xmp", ["--copy_num", "2"]),
    "no_sidecar": ("img.nef", None, []),
}


def _run(tmp_path, side, case, checkpoint):
    fname, sidecar, extra = CASES[case]
    d = tmp_path / side
    d.mkdir()
    log = str(d / "tools.jsonl")
    dt = fixtures.write_darktable(str(d / "darktable-cli"), log, H, W, seed=4)
    gmic = fixtures.write_gmic(str(d / "gmic"), log)
    src = d / fname
    if fname.endswith(".tif"):
        _tiff(src, seed=2)
    else:
        src.write_bytes(b"not really a raw file")
    if sidecar:
        (d / sidecar).write_text(SIDECAR)
    argv = [str(src), "--dt", dt, "-g", gmic, "--model_path", checkpoint] + COMMON + extra
    cli = jax_cli if side == "jax" else port_cli
    out = cli.main(argv + (["--device", "cpu"] if side == "port" else []))
    calls = json.dumps(fixtures.read_log(log)).replace(str(d), "<dir>")
    return d, out, json.loads(calls)


@pytest.mark.parametrize("case", list(CASES))
def test_darktable_paths_match_jax(tmp_path, monkeypatch, checkpoint, case):
    seen = _capture(monkeypatch)
    jd, _, jax_calls = _run(tmp_path, "jax", case, checkpoint)
    pd, out, port_calls = _run(tmp_path, "port", case, checkpoint)
    assert port_calls == jax_calls
    files = sorted(os.listdir(pd))
    assert files == sorted(os.listdir(jd))
    if case == "no_sidecar":
        assert out is None and port_calls == [] and seen == {"jax": [], "port": []}
        return
    assert out == pd / "img.jpg" and out.is_file()
    stages = [c["argv"] for c in port_calls if c["tool"] == "darktable-cli"]
    if case != "tiff_sidecar":  # stage 1: 32-bit TIFF
        assert "plugins/imageio/format/tiff/bpp=32" in stages.pop(0)
    s2 = stages.pop(0)  # stage 2: 16-bit, with the height
    assert "plugins/imageio/format/tiff/bpp=16" in s2
    assert s2[s2.index("--height") + 1] == ("120" if case == "raw" else "0")
    assert not stages
    if case in ("use_gmic", "no_deblur"):  # the stand-in wrote the 8-bit output
        assert seen == {"jax": [], "port": []}
        got = cv2.imread(str(pd / "img.jpg.png"))
        ref = cv2.imread(str(jd / "img.jpg.png"))
    else:
        (ref,), (got,) = seen["jax"], seen["port"]
    assert got.shape == ref.shape == (H, W, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    if case == "debug_nightmode":
        assert {"img_s1.tif", "img_s1_denoised.tiff", "img_s2.tif",
                "img.nef.s1.xmp", "img.nef.s2.xmp"} <= set(files)
        for k in (1, 2):
            _assert_same_tree(ET.parse(pd / f"img.nef.s{k}.xmp").getroot(),
                              ET.parse(jd / f"img.nef.s{k}.xmp").getroot())
        # both CLIs write the denoised TIFF through fp16 (denoise_image's
        # .tiff output at default precision): one fp16 ulp at the value (at
        # most 2^-10 of it), plus the 16-bit rounding of stage 2
        for name, lsb in (("img_s1_denoised.tiff", 0), ("img_s2.tif", 1)):
            a = cv2.imread(str(pd / name), cv2.IMREAD_UNCHANGED).astype(np.float64)
            b = cv2.imread(str(jd / name), cv2.IMREAD_UNCHANGED).astype(np.float64)
            bound = 2.0 ** -10 * np.maximum(np.abs(a), np.abs(b)) + 2.0 ** -24 + lsb
            assert (np.abs(a - b) <= bound).all(), name


def test_missing_checkpoint_raises_naming_it(tmp_path, monkeypatch):
    """A missing table checkpoint is fetched from the table's URL; a failed
    fetch (here refused, so nothing leaves the machine) raises naming the
    path and the URL, and leaves no JPEG and no ``.part``."""
    import urllib.request

    def refuse(url, filename=None, *a, **k):
        if filename:
            with open(filename, "wb") as f:
                f.write(b"partial")
        raise OSError(f"refused: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.chdir(tmp_path)
    tif = _tiff(tmp_path / "img.tif")
    with pytest.raises(RuntimeError, match="could not download") as e:
        port_cli.main([str(tif), "--tiff-input", "--device", "cpu"])
    assert os.path.join("models", "nind", "generator_650.pt") in str(e.value)
    assert "https://" in str(e.value)
    assert not (tmp_path / "img.jpg").exists()
    assert not (tmp_path / "models" / "nind" / "generator_650.pt.part").exists()
    assert not (tmp_path / "models" / "nind" / "generator_650.pt").exists()


def test_raw_without_darktable_raises(tmp_path, checkpoint):
    (tmp_path / "img.nef").write_bytes(b"raw")
    (tmp_path / "img.nef.xmp").write_text(SIDECAR)
    with pytest.raises(FileNotFoundError, match="darktable-cli"):
        port_cli.main([str(tmp_path / "img.nef"), "--dt", str(tmp_path / "none"),
                       "--model_path", checkpoint, "--device", "cpu"])


@pytest.mark.parametrize("cli,argv,exc,item", [
    # --trace_dir runs since the profiler capture was ported (tests/test_torch_legacy.py);
    # a refused run writes no trace
    ("denoise_image", ["--network", "DnCNN", "--trace_dir", "trace"], ValueError,
     "unsupported generator"),
    # the relic zoo is in the registry, not in the engine, as in JAX
    ("denoise_image", ["--network", "HuNet"], ValueError, "unsupported generator"),
])
def test_flags_not_ported_raise(tmp_path, monkeypatch, checkpoint, cli, argv, exc, item):
    monkeypatch.chdir(tmp_path)  # a relative --trace_dir would land here
    tif = _tiff(tmp_path / "img.tif")
    with pytest.raises(exc, match=item):
        if cli == "denoise":
            port_cli.main([str(tif), "--tiff-input", "--model_path", checkpoint,
                           "--device", "cpu"] + argv)
        else:
            port_image_cli.main(["-i", str(tif), "-o", str(tmp_path / "o.tif"),
                                 "--network", "UtNet", "--model_path", checkpoint,
                                 "--device", "cpu"] + argv)
    assert sorted(os.listdir(tmp_path)) == ["img.tif"]


def test_directory_loads_once_and_matches_single_runs(tmp_path, monkeypatch, checkpoint):
    src = tmp_path / "in"
    src.mkdir()
    for i, hw in enumerate([(H, W), (H, W), (40, 44), (H, W)]):  # f2: tiny path
        _tiff(src / f"f{i}.tif", seed=10 + i, hw=hw)
    (src / "notes.txt").write_text("skipped")
    loads, engines = [], []
    load = port_cli.params_io.load_generator
    monkeypatch.setattr(port_cli.params_io, "load_generator",
                        lambda *a, **kw: loads.append(a) or load(*a, **kw))

    class Counted(port_engine.TileEngine):
        def __init__(self, *a, **kw):
            engines.append((a[1], a[2]))
            super().__init__(*a, **kw)

    monkeypatch.setattr(port_engine, "TileEngine", Counted)
    seen = _capture(monkeypatch)["port"]
    argv = ["--tiff-input", "--model_path", checkpoint, "--device", "cpu"] + COMMON
    (tmp_path / "dir").mkdir()
    outs = port_cli.main([str(src), "-o", str(tmp_path / "dir")] + argv)
    assert [o.name for o in outs] == ["f0.jpg", "f1.jpg", "f2.jpg", "f3.jpg"]
    assert len(loads) == 1
    assert engines == [(104, 88), (104, 88)]  # the tiled engine, the tiny one
    batch = list(seen)
    for i in range(4):
        (tmp_path / f"one{i}").mkdir()
        port_cli.main([str(src / f"f{i}.tif"), "-o", str(tmp_path / f"one{i}")] + argv)
    assert len(loads) == 5
    for got, ref in zip(batch, seen[4:]):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cli", ["denoise_image", "denoise"])
def test_devices_2_runs(tmp_path, monkeypatch, checkpoint, cli):
    """``--devices 2 --device cpu``: denoise_image by row bands over two CPU
    devices, denoise with a directory of two same-shape files one a device;
    each output within 1 LSB of its ``--devices 1`` run (the tiles per
    dispatch differ, and torch's CPU convolutions round by batch)."""
    src = tmp_path / "in"
    src.mkdir()
    for i in range(2):
        _tiff(src / f"f{i}.tif", seed=30 + i)
    if cli == "denoise_image":
        outs = {}
        for n in ("1", "2"):
            out = str(tmp_path / f"o{n}.tif")
            port_image_cli.main(["-i", str(src / "f0.tif"), "-o", out, "--network", "UtNet",
                                 "--model_path", checkpoint, "--cs", "104", "--ucs", "88",
                                 "-b", "2", "--compute_dtype", "float32", "--device", "cpu",
                                 "--exif_method", "noexif", "--devices", n])
            outs[n] = cv2.imread(out, cv2.IMREAD_UNCHANGED).astype(int)
        assert outs["2"].shape == (H, W, 3)
        assert np.abs(outs["2"] - outs["1"]).max() <= 1
        return
    seen = _capture(monkeypatch)["port"]
    argv = ["--tiff-input", "--model_path", checkpoint, "--device", "cpu"] + COMMON
    for n in ("1", "2"):
        (tmp_path / n).mkdir()
        outs = port_cli.main([str(src), "-o", str(tmp_path / n), "--devices", n] + argv)
        assert [o.name for o in outs] == ["f0.jpg", "f1.jpg"] and all(o.is_file() for o in outs)
    assert len(seen) == 4
    for got, ref in zip(seen[2:], seen[:2]):
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_devices_1_runs(tmp_path, checkpoint):
    tif = _tiff(tmp_path / "img.tif")
    out = port_cli.main([str(tif), "--tiff-input", "--model_path", checkpoint, "-o",
                         str(tmp_path), "--device", "cpu", "--devices", "1"] + COMMON)
    assert out.is_file()


# -- UNet through the front ends ----------------------------------------------

@pytest.fixture(scope="module")
def unet_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("unet") / "unet_generator_1.npz")
    fixtures.write_unet_checkpoint(path, seed=5)
    return path


@pytest.mark.parametrize("autodetect", [False, True])
def test_unet_image_cli_matches_jax(tmp_path, monkeypatch, unet_checkpoint, autodetect):
    """``denoise_image --network UNet`` (tiled, cs 104 / ucs 88) and the
    network autodetected from a path holding "unet" (UNet's default 440 /
    320 tiling, which this image is below: one padded forward): the 16-bit
    outputs within 1 LSB of JAX's."""
    monkeypatch.setattr(jax_image_cli, "_resolve_devices", lambda args: 1)
    tif = _tiff(tmp_path / "img.tif", seed=3)
    outs = []
    for side, cli in (("jax", jax_image_cli), ("port", port_image_cli)):
        out = tmp_path / f"{side}.tif"
        argv = ["-i", str(tif), "-o", str(out), "--model_path", unet_checkpoint,
                "--compute_dtype", "float32", "-b", "2"]
        argv += [] if autodetect else ["--network", "UNet", "--cs", "104", "--ucs", "88"]
        cli.main(argv + (["--device", "cpu"] if side == "port" else []))
        outs.append(cv2.imread(str(out), cv2.IMREAD_UNCHANGED))
    ref, got = outs
    assert got.shape == ref.shape == (H, W, 3) and got.dtype == np.uint16
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_unet_model_entry_matches_jax(tmp_path, monkeypatch, unet_checkpoint):
    """``denoise`` with a model table entry whose network is UNet, in memory
    (``--tiff-input``, no sidecar) with RL on the device and ``--devices
    1``: the pre-encode uint8 within 1 LSB of the JAX CLI's."""
    seen = _capture(monkeypatch)
    for mod in (jax_cli, port_cli):
        read = mod.xmp.read_config

        def with_unet(*a, _read=read, **kw):
            cfg = _read(*a, **kw)
            cfg["models"]["unet"] = {"path": unet_checkpoint, "network": "UNet"}
            return cfg

        monkeypatch.setattr(mod.xmp, "read_config", with_unet)
    tif = _tiff(tmp_path / "img.tif", seed=6)
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        (tmp_path / side).mkdir()
        cli.main([str(tif), "--tiff-input", "--model", "unet", "-o", str(tmp_path / side),
                  "--devices", "1"] + COMMON + (["--device", "cpu"] if side == "port" else []))
    (ref,), (got,) = seen["jax"], seen["port"]
    assert got.shape == ref.shape == (H, W, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
