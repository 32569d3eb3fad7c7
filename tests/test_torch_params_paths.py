"""The port's checkpoint path resolution and meta-device load.

``complete_path``, ``find_best`` and ``find_highest`` against the JAX
package's on the same temporary trees (epochs, trainres.json, models_dpath,
the discriminator2 trap); ``load_generator`` (built on the meta device,
tensors assigned) against an eager build + load: equal state_dicts bit for
bit, a bit-equal forward, no parameter left on meta, and strictness kept."""

import json
import os

import numpy as np
import pytest
import torch

from nind_denoise_tpu.models import params_io as jax_params_io
from nind_denoise_tpu_torch.engine.tile_engine import resolve_apply_fn
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.models.utnet import UtNet
from nind_denoise_tpu_torch.tools.fixtures import write_jax_checkpoint


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "wb").close()
    return path


@pytest.fixture
def trees(tmp_path):
    root = tmp_path / "models"
    epochs = root / "epochs"
    for e in (1, 12, 3):
        _touch(str(epochs / f"generator_{e}.npz"))
    best = root / "best"
    for e in (2, 7):
        _touch(str(best / f"generator_{e}.pt"))
    (best / "trainres.json").write_text(json.dumps(
        {"best_epoch": {"validation_loss": 2}}))
    nokey = root / "nokey"
    _touch(str(nokey / "generator_4.npz"))
    (nokey / "trainres.json").write_text(json.dumps({"best_epoch": {}}))
    trap = root / "trap"
    for fn in ("discriminator_5.pt", "discriminator2_9.pt", "generator_1.npz"):
        _touch(str(trap / fn))
    (root / "empty").mkdir()
    return root


RESOLVE = [  # (path relative to the tree, models_dpath?, keyword)
    ("epochs", False, "generator"), ("best", False, "generator"),
    ("nokey", False, "generator"), ("trap", False, "discriminator"),
    ("trap", False, "discriminator2"), ("best", True, "generator"),
    ("epochs/generator_3.npz", False, "generator"),
]


@pytest.mark.parametrize("rel,by_name,keyword", RESOLVE)
def test_complete_path_matches_jax(trees, rel, by_name, keyword):
    path, mdir = (rel, str(trees)) if by_name else (str(trees / rel), None)
    ref = jax_params_io.complete_path(path, mdir, keyword)
    assert params_io.complete_path(path, mdir, keyword) == ref
    d = str(trees / rel.split("/")[0])
    assert params_io.find_highest(d, keyword) == jax_params_io.find_highest(d, keyword)
    assert params_io.find_best(d, keyword) == jax_params_io.find_best(d, keyword)


@pytest.mark.parametrize("rel", ["empty", "missing", "epochs/generator_99.npz"])
def test_complete_path_raises_like_jax(trees, rel):
    with pytest.raises(FileNotFoundError):
        jax_params_io.complete_path(str(trees / rel))
    with pytest.raises(FileNotFoundError):
        params_io.complete_path(str(trees / rel))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    os.makedirs(d / "run")
    path = str(d / "run" / "generator_5.npz")
    write_jax_checkpoint(path, 8, seed=3)
    return path, params_io.state_dict_from_jax(jax_params_io.load(path))


def _eager(sd):
    m = UtNet(8)
    m.load_state_dict(sd, strict=True)
    return m


@pytest.mark.parametrize("fmt", ["npz", "pt", "dir"])
def test_meta_load_equals_eager_load(checkpoint, tmp_path, fmt):
    path, sd = checkpoint
    if fmt == "pt":
        path = str(tmp_path / "generator_5.pt")
        torch.save(sd, path)
    elif fmt == "dir":
        path = os.path.dirname(path)
    model, ref = params_io.load_generator(path), _eager(sd)
    got_sd, ref_sd = model.state_dict(), ref.state_dict()
    assert list(got_sd) == list(ref_sd)
    for k, v in ref_sd.items():
        assert got_sd[k].dtype == torch.float32 and got_sd[k].device.type == "cpu", k
        assert torch.equal(got_sd[k], v), k
    assert not any(p.is_meta for p in model.parameters())
    assert not any(b.is_meta for b in model.buffers())
    assert all(p.requires_grad for p in model.parameters())
    x = torch.from_numpy(np.random.default_rng(0).random((1, 3, 104, 104),
                                                        dtype=np.float32))
    with torch.no_grad():
        assert torch.equal(model(x), ref(x))


def test_meta_load_then_cast_moves_every_parameter(checkpoint):
    """After the assigned load, resolve_apply_fn's .to(device, dtype) casts
    every parameter of its copy, leaves the loaded model fp32, and the w1
    that K2's pack_w1 reads is contiguous."""
    model = params_io.load_generator(checkpoint[0])
    fwd = resolve_apply_fn("UtNet", model, "bfloat16", "cpu")
    sd = model.state_dict()
    for name, p in fwd.named_parameters():
        assert p.dtype == torch.bfloat16 and not p.requires_grad, name
        assert torch.equal(p, sd[name].to(torch.bfloat16)), name
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert fwd.convs1[2].weight.is_contiguous()


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_meta_load_stays_strict(checkpoint, tmp_path, fault):
    sd = dict(checkpoint[1])
    if fault == "missing":
        sd.pop("up2.bias")
    elif fault == "extra":
        sd["convs9.0.weight"] = torch.zeros(1)
    else:
        sd["up2.bias"] = torch.zeros(3)
    path = str(tmp_path / "generator_1.pt")
    torch.save(sd, path)
    with pytest.raises(RuntimeError):
        params_io.load_generator(path)
