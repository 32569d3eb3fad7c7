"""The port's training datasets (``nind_denoise_tpu_torch/train/dataset.py``
and the pair helpers of ``core/imgio.py``) against the JAX package's: one
seed must give the same arrays, bit for bit, item for item and (with one
loader thread) batch for batch, augmentations included."""

import csv
import os
import random

import cv2
import numpy as np
import pytest
import yaml

from nind_denoise_tpu.core import imgio as jax_imgio
from nind_denoise_tpu.train import dataset as jax_ds
from nind_denoise_tpu_torch.core import imgio
from nind_denoise_tpu_torch.train import dataset as ds


@pytest.fixture(scope="module")
def nind(tmp_path_factory):
    """<root>/<set>/ISO<val>/<DS>_<set>_<iso>_<x>_<y>_<ucs>.png crops, 16 bit,
    with a duplicated base ISO and an ISOH set; plus whole test scenes and
    a clean-image directory."""
    base = tmp_path_factory.mktemp("nind")
    root = base / "SYN_72_64"
    rng = np.random.default_rng(0)
    for aset, isos in (("sceneA", ("ISO200", "ISO200-2", "ISO1600", "ISO6400")),
                       ("sceneB", ("ISO100", "ISO3200", "ISOH1")),
                       ("reservedC", ("ISO200", "ISO800"))):
        clean = rng.random((72, 72, 3))
        for k, iso in enumerate(isos):
            d = root / aset / iso
            d.mkdir(parents=True)
            for x in (0, 64, 128):
                img = np.clip(clean + rng.normal(0, 0.03 * k, clean.shape), 0, 1)
                cv2.imwrite(str(d / f"SYN_{aset}_{iso}_{x}_0_64.png"),
                            (img * 65535).astype(np.uint16))
    whole = base / "whole"
    for scene in ("s1", "s2"):
        (whole / scene).mkdir(parents=True)
        for iso in ("ISO200", "ISO3200"):
            cv2.imwrite(str(whole / scene / f"SYN_{scene}_{iso}.png"),
                        (rng.random((150, 140, 3)) * 65535).astype(np.uint16))
    cleandir = base / "clean"
    cleandir.mkdir()
    for i in range(5):
        cv2.imwrite(str(cleandir / f"c{i}.png"),
                    (rng.random((70, 90, 3)) * 255).astype(np.uint8))
    return {"root": str(root), "whole": str(whole), "clean": str(cleandir)}


def _same_items(a, b, n=None):
    for i in range(len(a) if n is None else n):
        xa, ya = a[i % len(a)]
        xb, yb = b[i % len(b)]
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        assert xa.dtype == xb.dtype == np.float32


def test_sort_isos_matches_jax():
    for raw in (["ISO6400", "ISO200", "ISOH1", "ISO800"],
                ["ISO200", "ISO200-1", "ISO800", "ISO800-2"],
                ["GT-A", "NOISY-B", "NOISY-A"], ["A", "C", "B"]):
        assert ds.sort_isos(list(raw)) == jax_ds.sort_isos(list(raw))


@pytest.mark.parametrize("kwargs", [
    {"cs": 64},                                                  # random crop
    {"cs": 80, "exp_mult_min": 0.7, "exp_mult_max": 1.3},        # pad + exposure
    {"cs": 64, "compressionmin": 60, "compressionmax": 90,
     "sigmamin": 2, "sigmamax": 10},                             # JPEG + noise
    {"cs": 64, "test_reserve": ["sceneA"], "exact_reserve": True},
    {"test_reserve": ["reserved"], "min_crop_size": 64, "cache_images": True},
])
def test_denoising_dataset_matches_jax(nind, kwargs):
    a = jax_ds.DenoisingDataset([nind["root"]], seed=7, **kwargs)
    b = ds.DenoisingDataset([nind["root"]], seed=7, **kwargs)
    assert a.dataset == b.dataset and len(a) == len(b) > 0
    assert (a.cs, a.min_crop_size) == (b.cs, b.min_crop_size)
    _same_items(a, b, n=2 * len(a))
    assert a.get_x_y_paths(1) == b.get_x_y_paths(1)
    assert list(a.all_crop_pairs()) == list(b.all_crop_pairs())


def test_picky_clean_and_lazy_datasets_match_jax(nind, tmp_path):
    pairs = list(jax_ds.DenoisingDataset([nind["root"]], cs=64).all_crop_pairs())
    fpath = tmp_path / "crops.csv"
    with open(fpath, "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(("xpath", "ypath", "score"))
        for i, (x, y) in enumerate(pairs):
            w.writerow((x, y, i / len(pairs)))
    a = jax_ds.PickyDenoisingDatasetFromList(str(fpath), min_quality=0.5, cs=64, seed=1)
    b = ds.PickyDenoisingDatasetFromList(str(fpath), min_quality=0.5, cs=64, seed=1)
    assert a.dataset == b.dataset and 0 < len(b) < len(pairs)
    _same_items(a, b)
    _same_items(jax_ds.CleanCleanDataset(nind["clean"], cs=64, seed=2),
                ds.CleanCleanDataset(nind["clean"], cs=64, seed=2))
    _same_items(jax_ds.LazyNoiseDataset([nind["root"]], cs=64, seed=3),
                ds.LazyNoiseDataset([nind["root"]], cs=64, seed=3))


def test_test_and_validation_datasets_match_jax(nind, tmp_path):
    a = jax_ds.TestDenoiseDataset(nind["whole"])
    b = ds.TestDenoiseDataset(nind["whole"])
    assert a.ds == b.ds and len(b) == 2
    _same_items(a, b)
    assert b[0][0].shape == (3, 128, 128)
    with pytest.raises(IndexError):
        b[len(b)]
    assert ds.get_baseline_fpath(os.path.join(nind["whole"], "s1")) == \
        jax_ds.get_baseline_fpath(os.path.join(nind["whole"], "s1"))
    pairs = [list(p) for p in
             jax_ds.DenoisingDataset([nind["root"]], cs=64).all_crop_pairs()][:3]
    vy = tmp_path / "val.yaml"
    vy.write_text(yaml.safe_dump(pairs))
    _same_items(jax_ds.ValidationDataset(str(vy), cs=56), ds.ValidationDataset(str(vy), cs=56))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_batches_match_jax(nind, shuffle, drop_last):
    def batches(mod):
        d = mod.DenoisingDataset([nind["root"]], cs=64, seed=5, exp_mult_min=0.9,
                                 exp_mult_max=1.1)
        loader = mod.Loader(d, 4, shuffle=shuffle, drop_last=drop_last,
                            num_threads=1, seed=5)
        return len(loader), [b for _ in range(2) for b in loader]

    (na, a), (nb, b) = batches(jax_ds), batches(ds)
    assert na == nb and len(a) == len(b) == 2 * nb
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xb.shape == (xb.shape[0], 64, 64, 3) and xb.flags.c_contiguous
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_threaded_loader_yields_every_batch(nind):
    d = ds.DenoisingDataset([nind["root"]], cs=64, seed=0)
    loader = ds.Loader(d, 2, num_threads=3, seed=0)
    got = list(loader)
    assert len(got) == len(loader) == len(d) // 2
    assert all(x.shape == (2, 64, 64, 3) for x, _ in got)


def test_loader_worker_error_propagates(nind, monkeypatch):
    d = ds.DenoisingDataset([nind["root"]], cs=64, seed=0)
    monkeypatch.setattr(ds.imgio, "load_img", lambda p: (_ for _ in ()).throw(OSError(p)))
    with pytest.raises(RuntimeError, match="Loader worker failed"):
        list(ds.Loader(d, 2, num_threads=2))


def test_imgio_pair_helpers_match_jax():
    rng = np.random.default_rng(4)
    a = rng.random((3, 50, 61), dtype=np.float32)
    b = rng.random((3, 50, 61), dtype=np.float32)
    for got, ref in zip(imgio.pad_img_pair(a, b, 64), jax_imgio.pad_img_pair(a, b, 64)):
        np.testing.assert_array_equal(got, ref)
        assert got.shape == (3, 64, 64)
    for method in ("RAND", "CENTER"):
        got = imgio.crop_img_pair(a, b, 40, getattr(imgio.CropMethod, method),
                                  rng=random.Random(3))
        ref = jax_imgio.crop_img_pair(a, b, 40, getattr(jax_imgio.CropMethod, method),
                                      rng=random.Random(3))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(imgio.crop_to_multiple(a, 16),
                                  jax_imgio.crop_to_multiple(a, 16))
    assert imgio.crop_to_multiple(a, 16).shape == (3, 48, 48)
