"""The port's dataset tools (``nind_denoise_tpu_torch/tools``) and the crop
audit (``DenoisingDataset.list_content_quality``) against the JAX package's
on the same seeded scenes, on the CPU.

``crop_ds``: the same file tree, every crop bit-equal (PNG and TIFF
sources; JPEG sources re-encoded by OpenCV on both sides, no jpegtran
here). ``make_dataset_crops_list``: the same CSV rows in the same order,
scores within ``SCORE_TOL``. ``filter_dataset_by_iso``: the same kept set
(PIL-written EXIF; no piexif here). ``pick_validation_set``: the same YAML
for one seed.
"""

import csv
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from nind_denoise_tpu.tools import crop_ds as jax_crop
from nind_denoise_tpu.tools import filter_dataset_by_iso as jax_filter
from nind_denoise_tpu.tools import make_dataset_crops_list as jax_list
from nind_denoise_tpu.tools import pick_validation_set as jax_pick
from nind_denoise_tpu_torch.tools import crop_ds as port_crop
from nind_denoise_tpu_torch.tools import filter_dataset_by_iso as port_filter
from nind_denoise_tpu_torch.tools import make_dataset_crops_list as port_list
from nind_denoise_tpu_torch.tools import pick_validation_set as port_pick
from nind_denoise_tpu_torch.train.dataset import PickyDenoisingDatasetFromList

SCORE_TOL = 1e-6  # MS-SSIM of a crop pair, port against JAX


def _scene(rng, h, w):
    img = cv2.resize(rng.random((h // 8, w // 8, 3)).astype(np.float32), (w, h),
                     interpolation=cv2.INTER_CUBIC)
    return np.clip(img, 0, 1)


def _write_scenes(root, sets, hw=(200, 260), seed=0):
    """``sets``: {set: [(iso tag, extension), ...]}, the first the clean
    one; noisy images add seeded Gaussian noise."""
    rng = np.random.default_rng(seed)
    for aset, files in sets.items():
        d = root / aset
        d.mkdir(parents=True)
        clean = _scene(rng, *hw)
        for i, (tag, ext) in enumerate(files):
            img = np.clip(clean + rng.normal(0, 0.04 * i, clean.shape), 0, 1)
            u = (img * 255).astype(np.uint8) if ext == ".jpg" \
                else (img * 65535).astype(np.uint16)
            assert cv2.imwrite(str(d / f"NIND_{aset}_{tag}{ext}"), u)
    return root


@pytest.fixture(scope="module")
def audit_tree(tmp_path_factory):
    """Two sets (PNG, TIFF), three ISOs each, cropped at cs 176 / stride 88
    by JAX's crop_ds: four crops an image, 16 pairs."""
    root = tmp_path_factory.mktemp("audit")
    _write_scenes(root / "NIND", {
        "S1": [("ISO100", ".png"), ("ISO800", ".png"), ("ISO3200", ".png")],
        "S2": [("ISO200", ".tif"), ("ISO1600", ".tif"), ("ISO6400", ".tif")]})
    jax_crop.main(["--cs", "176", "--stride", "88", "--orig_data", str(root / "NIND"),
                   "--resdir", str(root / "cropped"), "--workers", "2"])
    return root / "cropped" / "NIND_176_88"


def _tree(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


def test_crop_ds_matches_jax(tmp_path):
    """PNG, TIFF and JPEG sources and a repeated ISO (its ``-2`` name), at a
    stride that leaves clamped edge tiles."""
    orig = _write_scenes(tmp_path / "DS", {
        "S1": [("ISO100", ".png"), ("ISO800", ".png")],
        "S2": [("ISO200", ".tif"), ("ISO3200", ".tif")],
        "S3": [("ISO100", ".jpg"), ("ISO6400", ".jpg")]})
    src = orig / "S1" / "NIND_S1_ISO800.png"
    src.rename(orig / "S1" / "NIND_S1b_ISO100.png")  # a second ISO100
    argv = ["--cs", "64", "--stride", "48", "--orig_data", str(orig), "--workers", "2"]
    jax_crop.main(argv + ["--resdir", str(tmp_path / "jax")])
    total = port_crop.main(argv + ["--resdir", str(tmp_path / "port")])
    ref, got = tmp_path / "jax" / "DS_64_48", tmp_path / "port" / "DS_64_48"
    files = _tree(ref)
    assert _tree(got) == files and total == len(files) == 6 * 24
    assert {f.split(os.sep)[1] for f in files} == {"ISO100", "ISO100-2", "ISO200",
                                                  "ISO3200", "ISO6400"}
    for f in files:
        a = cv2.imread(str(ref / f), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(got / f), cv2.IMREAD_UNCHANGED)
        assert a.shape == (64, 64, 3) and np.array_equal(a, b), f
        if not f.endswith(".jpg"):
            assert (got / f).read_bytes() == (ref / f).read_bytes(), f
    assert port_crop.crop_grid(500, 300, 256, 192) == jax_crop.crop_grid(500, 300, 256, 192)


def _rows(path):
    with open(path) as fp:
        return list(csv.reader(fp))


def test_crops_list_matches_jax(audit_tree, tmp_path):
    jax_list.main(["--train_data", str(audit_tree), "--out_dir", str(tmp_path / "jax")])
    rows = port_list.main(["--train_data", str(audit_tree), "--out_dir",
                           str(tmp_path / "port"), "--device", "cpu"])
    ref = _rows(tmp_path / "jax" / "NIND_176_88-msssim.csv")
    got = _rows(tmp_path / "port" / "NIND_176_88-msssim.csv")
    assert got[0] == ref[0] == ["xpath", "ypath", "score"]
    assert [r[:2] for r in got] == [r[:2] for r in ref] and len(got) == 1 + 16
    assert [list(r[:2]) for r in rows] == [r[:2] for r in got[1:]]
    diffs = [abs(float(g[2]) - float(r[2])) for g, r in zip(got[1:], ref[1:])]
    assert max(diffs) <= SCORE_TOL, max(diffs)
    assert all(0 < float(r[2]) < 1 for r in got[1:])
    # the CSV is what the picky dataset reads
    picky = PickyDenoisingDatasetFromList(str(tmp_path / "port" / "NIND_176_88-msssim.csv"),
                                          min_quality=0.0, cs=128, seed=0)
    assert len(picky) == 16
    x, y = picky.load_pair(0)
    assert x.shape == y.shape == (3, 128, 128)


def test_pick_validation_set_matches_jax(audit_tree, tmp_path):
    outs = []
    for mod, side in ((jax_pick, "jax"), (port_pick, "port")):
        outs.append(mod.main(["--train_data", str(audit_tree), "--test_reserve", "S2",
                              "-n", "5", "--seed", "3", "--out_dir", str(tmp_path / side)]))
    ref, got = outs
    assert os.path.basename(got) == os.path.basename(ref) == \
        "validation_set_5_NIND_176_88_reserve.yaml"
    assert open(got).read() == open(ref).read()


def test_filter_dataset_by_iso_matches_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name, iso in (("a.jpg", 100), ("b.jpg", 400), ("c.jpg", 1600), ("d.jpg", None),
                      ("e.png", 100)):
        im = Image.fromarray(np.full((8, 8, 3), 128, np.uint8))
        exif = Image.Exif()
        if iso is not None:
            exif[port_filter.ISO_TAG] = iso
        im.save(src / name, exif=exif)
    kept = {}
    for mod, side in ((jax_filter, "jax"), (port_filter, "port")):
        mod.main(["--src_dir", str(src), "--dst_dir", str(tmp_path / side), "--max_iso", "400"])
        kept[side] = sorted(os.listdir(tmp_path / side))
    assert kept["port"] == kept["jax"] == ["a.jpg", "b.jpg"]
    assert [port_filter.get_iso(str(src / n)) for n in sorted(os.listdir(src))] == \
        [jax_filter.get_iso(str(src / n)) for n in sorted(os.listdir(src))]
