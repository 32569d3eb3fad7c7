"""The port's device-resident crop cache (``train/device_cache.py``) against
the JAX package's ``DeviceEpochCache``, on the CPU.

One seeded crop set (three scenes of two 48 px crops, two noisy ISOs
each, cropped to 32 px, exp_mult in [0.8, 1.25]) goes into each package's own
``DenoisingDataset`` with the same seed and one loader thread: the
cache's rows, its refreshes (including a block that wraps past the end)
and each epoch's batches must equal JAX's bit for bit, the batches given
JAX's augmentation draws. The port's own draws are held to the
reference's augmentation statistics, as tests/test_device_cache.py holds
JAX's.
"""

import cv2
import numpy as np
import pytest
import torch

import jax

from nind_denoise_tpu.train import dataset as jax_ds
from nind_denoise_tpu.train import device_cache as jax_dc
from nind_denoise_tpu_torch.train import dataset as ds_mod
from nind_denoise_tpu_torch.train import device_cache as dc

EXP = {"exp_mult_min": 0.8, "exp_mult_max": 1.25}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("dc") / "TEST_48_32"
    rng = np.random.default_rng(7)
    for s in range(3):
        for x in (0, 48):
            clean = rng.random((48, 48, 3)) * 0.7
            for iso, sigma in (("ISO100", 0.0), ("ISO1600", 0.05), ("ISO3200", 0.1)):
                d = base / f"scene{s}" / iso
                d.mkdir(parents=True, exist_ok=True)
                img = np.clip(clean + rng.normal(0, sigma, clean.shape), 0, 1)
                cv2.imwrite(str(d / f"TEST_scene{s}_{iso}_{x}_0_48.png"),
                            (img * 65535).astype(np.uint16))
    return str(base)


def _pair(root, capacity, refresh, **kw):
    j = jax_dc.DeviceEpochCache(jax_ds.DenoisingDataset([root], cs=32, seed=4, **kw),
                                capacity, seed=0, cache_dtype="float16", refresh_frac=refresh,
                                threads=1)
    p = dc.DeviceEpochCache(ds_mod.DenoisingDataset([root], cs=32, seed=4, **kw),
                            capacity, device="cpu", seed=0, refresh_frac=refresh, threads=1)
    return j, p


def _equal_caches(j, p):
    for a, b in ((j.cache_x, p.cache_x), (j.cache_y, p.cache_y)):
        assert b.dtype == getattr(torch, np.asarray(a).dtype.name)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_fill_and_refresh_with_wrap_match_jax(root):
    """Six rows of the six pairs, then refreshes of four rows: rows 0-3,
    then 4-5 and 0-1 (the wrap), each swapped at an epoch boundary."""
    j, p = _pair(root, 8, 0.6, **EXP)
    assert len(p) == len(j) == 6 and p._refresh_rows == j._refresh_rows == 4
    assert p.nbytes() == 2 * 6 * 32 * 32 * 3 * 2 and p.cache_x.dtype == torch.float16
    _equal_caches(j, p)
    for swaps in (1, 2):
        for c in (j, p):
            c.start_refresh()
            c._refresher.join(30)
        assert p.maybe_swap() and j.maybe_swap()
        assert p.swaps == j.swaps == swaps
        assert p.uploaded_rows == j.uploaded_rows == 6 + 4 * swaps
        _equal_caches(j, p)
    assert not p.maybe_swap()  # nothing pending


def test_epoch_batches_match_jax_given_its_draws(root, monkeypatch):
    """Two epochs of batch 4 (drop-last: one batch of six rows each): the
    permutation from the cache's rng, then the gather and ``augment``
    with JAX's per-step draws, bit-equal to ``_sample_batch_fn``'s."""
    j, p = _pair(root, 6, 0, **EXP)
    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, ek = jax.random.split(key)
        ref = [tuple(np.asarray(t) for t in b) for b in j.epoch_batches(4, ek)]
        subs = []
        k = ek
        for _ in ref:
            k, sub = jax.random.split(k)
            kr, kv, kh, ke = jax.random.split(sub, 4)
            subs.append(tuple(torch.from_numpy(np.array(a)) for a in (
                jax.random.randint(kr, (4,), 0, 4), jax.random.bernoulli(kv, 0.5, (4,)),
                jax.random.bernoulli(kh, 0.5, (4,)), jax.random.uniform(ke, (4,)))))
        it = iter(subs)
        monkeypatch.setattr(p, "draws", lambda bs, g: next(it))
        got = list(p.epoch_batches(4, torch.Generator()))
        assert len(got) == len(ref) == 1
        for (gx, gy), (rx, ry) in zip(got, ref):
            np.testing.assert_array_equal(gx.permute(0, 2, 3, 1).numpy(), rx)
            np.testing.assert_array_equal(gy.permute(0, 2, 3, 1).numpy(), ry)


def test_augment_is_jax_sampler_bit_for_bit():
    """``augment`` given the draws of ``_sample_batch_fn``'s key splits, on
    random crops whose max is below 1 (so exp_mult's upper bound is
    1/max on some, exp_mult_max on others), every rotation and flip."""
    rng = np.random.default_rng(1)
    n, bs = 16, 8
    cx = (rng.random((n, 9, 9, 3)) * rng.uniform(0.5, 1.0, (n, 1, 1, 1))).astype(np.float32)
    cy = rng.random((n, 9, 9, 3)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    sample = jax_dc._sample_batch_fn()
    key = jax.random.PRNGKey(0)
    seen = set()
    for step in range(2):
        for _ in range(4):
            key, sub = jax.random.split(key)
            rx, ry = sample(cx, cy, perm, step, sub, np.float32(0.9), np.float32(1.5), bs=bs)
            kr, kv, kh, ke = jax.random.split(sub, 4)
            draws = [np.asarray(a) for a in (
                jax.random.randint(kr, (bs,), 0, 4), jax.random.bernoulli(kv, 0.5, (bs,)),
                jax.random.bernoulli(kh, 0.5, (bs,)), jax.random.uniform(ke, (bs,)))]
            seen |= set(zip(*(d.tolist() for d in draws[:3])))
            idx = perm[step * bs:(step + 1) * bs]
            x, y = dc.augment(torch.from_numpy(cx[idx]), torch.from_numpy(cy[idx]),
                              *(torch.from_numpy(np.array(d)) for d in draws), 0.9, 1.5)
            np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
            np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    assert len(seen) == 16  # every rotation with every pair of flips


def _orientation(img, raw, em, clip=False):
    """Which of the 8 dihedral orientations of ``raw``, scaled by ``em``
    (and clipped), ``img`` is (-1 if none)."""
    for k, (rot, flip) in enumerate((r, f) for r in range(4) for f in (False, True)):
        cand = np.rot90(raw, rot, (0, 1))
        cand = (cand[:, ::-1] if flip else cand) * em
        if np.allclose(img, np.clip(cand, 0, 1) if clip else cand, rtol=1e-6, atol=1e-7):
            return k
    return -1


def test_own_draws_statistics(root):
    """The port's draws from a seeded generator: every output is one of
    the 8 dihedral orientations of its row, the same for clean and noisy;
    all 8 occur; exp_mult lies in [min, min(max, 1/max(clean))] and
    varies; the noisy crop is scaled and clipped; the same generator seed
    repeats the epoch."""
    _, p = _pair(root, 1, 0, **EXP)
    raw_x, raw_y = p.cache_x[0].numpy(), p.cache_y[0].numpy()
    hi = min(1.25, 1.0 / raw_x.max())
    g = torch.Generator().manual_seed(0)
    counts, ems = np.zeros(8, int), []
    for _ in range(96):  # P(an orientation missing) ~ 8 (7/8)^96 ~ 2e-5
        (x, y), = p.epoch_batches(1, g)
        x, y = x[0].permute(1, 2, 0).numpy(), y[0].permute(1, 2, 0).numpy()
        em = x.max() / raw_x.max()
        assert 0.8 - 1e-6 <= em <= hi + 1e-6 and y.max() <= 1.0
        k = _orientation(x, raw_x, em)
        assert k >= 0 and _orientation(y, raw_y, em, clip=True) == k
        counts[k] += 1
        ems.append(em)
    assert (counts > 0).all(), counts
    assert np.std(ems) > 1e-2
    (a, _), = p.epoch_batches(1, torch.Generator().manual_seed(3))
    (b, _), = p.epoch_batches(1, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_supports_gate_and_the_cli_fallback_dataset(root):
    ds = ds_mod.DenoisingDataset([root], cs=32, seed=0)
    assert dc.supports(ds) and jax_dc.supports(ds)
    jpeg = ds_mod.DenoisingDataset([root], cs=32, seed=0, compressionmin=60)
    noise = ds_mod.DenoisingDataset([root], cs=32, seed=0, sigmamax=3.0)
    for bad in (jpeg, noise, object()):
        assert not dc.supports(bad) and not jax_dc.supports(bad)
    with pytest.raises(ValueError, match="host-only augmentation"):
        dc.DeviceEpochCache(jpeg, 4)


@pytest.mark.parametrize("which", ["device_cache", "discriminator"])
def test_default_device_is_cuda_and_raises_without_it(root, which, monkeypatch):
    """The cache and the discriminator land on CUDA unless asked for the
    CPU: without CUDA the default raises and names ``device='cpu'``."""
    import types

    from nind_denoise_tpu_torch.train import gan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if which == "device_cache":
        make = lambda **kw: dc.DeviceEpochCache(
            ds_mod.DenoisingDataset([root], cs=32, seed=0), 2, threads=1, **kw)
        placed = lambda obj: obj.cache_x.device
    else:
        make = lambda **kw: gan.DiscriminatorWrapper(
            types.SimpleNamespace(beta1=0.75, models_dpath=None), "Hul112Disc", 2, 1e-4,
            True, seed=0, **kw)
        placed = lambda obj: next(obj.model.parameters()).device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert placed(make(device="cpu")).type == "cpu"
