"""The model table's checkpoint download in the port against the JAX package.

``external.download_model`` of both packages on the same ``file://`` source
(the bytes copied, a failed fetch raising ``RuntimeError`` with neither the
checkpoint nor its ``.part`` left); ``denoise_cli.resolve_model`` of both on
the same arguments and table (a missing table path or ``--model_path`` is
fetched from the entry's ``url``; an entry without one is the port's early
``FileNotFoundError``); and the port's CLI fetching a missing table
checkpoint before a run whose JPEG is bit-equal to a ``--model_path`` run on
the same weights. Every fetch stays on the machine: ``no_network`` refuses
any scheme but ``file``."""

import argparse
import os
import pathlib
import urllib.parse
import urllib.request

import cv2
import numpy as np
import pytest

from nind_denoise_tpu.pipeline import denoise_cli as jax_cli
from nind_denoise_tpu.pipeline import external as jax_external
from nind_denoise_tpu_torch.pipeline import denoise_cli as port_cli
from nind_denoise_tpu_torch.pipeline import external as port_external
from nind_denoise_tpu_torch.tools import fixtures

NAME = "nind_generator_650.pt"
TABLE_PATH = os.path.join("models", "nind", "generator_650.pt")
PACKAGES = {"jax": (jax_external, jax_cli), "port": (port_external, port_cli)}


def _url_of(req):
    return req.full_url if isinstance(req, urllib.request.Request) else str(req)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """``urlretrieve`` and ``urlopen`` take ``file://`` URLs only; any other
    scheme raises before a socket is opened. Returns the URLs fetched."""
    fetched = []
    retrieve, urlopen = urllib.request.urlretrieve, urllib.request.urlopen

    def guard(url):
        scheme = urllib.parse.urlsplit(url).scheme
        if scheme != "file":
            raise OSError(f"network refused in tests: {url}")

    def guarded_retrieve(url, *a, **kw):
        guard(url)
        fetched.append(url)
        return retrieve(url, *a, **kw)

    def guarded_urlopen(req, *a, **kw):
        guard(_url_of(req))
        return urlopen(req, *a, **kw)

    monkeypatch.setattr(urllib.request, "urlretrieve", guarded_retrieve)
    monkeypatch.setattr(urllib.request, "urlopen", guarded_urlopen)
    return fetched


def _part(dest):
    return pathlib.Path(str(dest) + ".part")


@pytest.mark.parametrize("side", sorted(PACKAGES))
def test_download_model_copies_the_bytes(tmp_path, side, no_network):
    external, _ = PACKAGES[side]
    src = tmp_path / "ckpt.bin"
    src.write_bytes(b"weights" * 1000)
    dest = tmp_path / "models" / "generator_650.pt"
    external.download_model(src.as_uri(), str(dest))
    assert dest.read_bytes() == src.read_bytes()
    assert not _part(dest).exists() and no_network == [src.as_uri()]


@pytest.mark.parametrize("side", sorted(PACKAGES))
def test_download_model_failure_cleans_partial(tmp_path, side):
    external, _ = PACKAGES[side]
    dest = tmp_path / "m" / "g.pt"
    url = (tmp_path / "missing.bin").as_uri()
    with pytest.raises(RuntimeError, match="could not download") as e:
        external.download_model(url, str(dest))
    assert url in str(e.value) and str(dest) in str(e.value)
    assert isinstance(e.value.__cause__, OSError)
    assert not dest.exists() and not _part(dest).exists()


def test_download_model_failure_after_a_partial_write(tmp_path, monkeypatch):
    """A fetch that dies after writing part of the file leaves no ``.part``
    in either package, and both raise the same type with the same text."""
    def dies(url, filename=None, *a, **kw):
        with open(filename, "wb") as f:
            f.write(b"half")
        raise ConnectionResetError("reset")

    monkeypatch.setattr(urllib.request, "urlretrieve", dies)
    errors = {}
    for side, (external, _) in PACKAGES.items():
        dest = tmp_path / "m" / "g.pt"
        with pytest.raises(Exception) as e:
            external.download_model("file:///nowhere/g.pt", str(dest))
        errors[side] = (type(e.value), str(e.value), type(e.value.__cause__))
        assert not dest.exists() and not _part(dest).exists()
    assert errors["port"] == errors["jax"]
    assert errors["port"][0] is RuntimeError


def test_download_model_same_bytes_in_both_packages(tmp_path):
    src = tmp_path / "published" / "generator_650.pt"
    src.parent.mkdir()
    fixtures.write_torch_checkpoint(str(src), 8, seed=5)
    got = {}
    for side, (external, _) in PACKAGES.items():
        dest = tmp_path / side / "deep" / "generator_650.pt"
        external.download_model(src.as_uri(), str(dest))
        got[side] = dest.read_bytes()
    assert got["port"] == got["jax"] == src.read_bytes()


def _table(url=None):
    entry = {"path": TABLE_PATH, "network": "UtNet", "funit": 64, "activation": "PReLU"}
    if url is not None:
        entry["url"] = url
    return {"models": {NAME: entry}}


# (what is on disk before the call, --model_path, whether the table has a url)
RESOLVE = {
    "table_path_present": ("table", None, True),
    "table_path_missing": (None, None, True),
    "model_path_present": ("override", "mine/g.pt", True),
    "model_path_missing": (None, "mine/g.pt", True),
    "model_path_absolute_missing": (None, "ABS", True),
    "no_url_present": ("table", None, False),
}


@pytest.mark.parametrize("case", sorted(RESOLVE))
def test_resolve_model_matches_jax(tmp_path, monkeypatch, no_network, case):
    present, model_path, with_url = RESOLVE[case]
    src = tmp_path / "published.pt"
    src.write_bytes(b"published weights")
    config = _table(src.as_uri() if with_url else None)
    got = {}
    for side, (_, cli) in PACKAGES.items():
        cwd = tmp_path / side
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        mp = str(cwd / "abs" / "g.pt") if model_path == "ABS" else model_path
        if present:
            on_disk = cwd / (TABLE_PATH if present == "table" else mp)
            on_disk.parent.mkdir(parents=True)
            on_disk.write_bytes(b"local weights")
        before = len(no_network)
        mcfg = cli.resolve_model(argparse.Namespace(model=NAME, model_path=mp), config)
        fetched = no_network[before:]
        path = pathlib.Path(mcfg["path"])
        assert path.is_absolute() and path.is_file() and not _part(path).exists()
        got[side] = (dict(mcfg, path=os.path.relpath(mcfg["path"], cwd)),
                     path.read_bytes(), fetched)
    assert got["port"] == got["jax"]
    mcfg, data, fetched = got["port"]
    assert mcfg.get("url") == (src.as_uri() if with_url else None)
    assert mcfg["path"] == (TABLE_PATH if model_path is None else
                            os.path.join("abs", "g.pt") if model_path == "ABS" else model_path)
    assert (data, fetched) == ((b"local weights", []) if present else
                               (b"published weights", [src.as_uri()]))


def test_resolve_model_without_url_raises_early(tmp_path, monkeypatch, no_network):
    """The deliberate difference: a missing checkpoint whose entry has no
    ``url`` raises FileNotFoundError naming the path in the port; JAX
    returns the entry and fails later, at the checkpoint's load."""
    monkeypatch.chdir(tmp_path)
    args = argparse.Namespace(model=NAME, model_path=None)
    mcfg = jax_cli.resolve_model(args, _table())
    assert mcfg["path"] == str(tmp_path / TABLE_PATH) and "url" not in mcfg
    with pytest.raises(FileNotFoundError) as e:
        port_cli.resolve_model(args, _table())
    assert str(tmp_path / TABLE_PATH) in str(e.value)
    assert no_network == [] and not (tmp_path / "models").exists()


def _with_url(monkeypatch, url):
    """The port CLI's model table with the default entry's ``url`` set."""
    read = port_cli.xmp.read_config

    def read_with(*a, **kw):
        cfg = read(*a, **kw)
        cfg["models"][NAME] = dict(cfg["models"][NAME], url=url)
        return cfg

    monkeypatch.setattr(port_cli.xmp, "read_config", read_with)


def test_cli_fetches_the_missing_table_checkpoint(tmp_path, monkeypatch, no_network):
    src = tmp_path / "published" / "generator_650.pt"
    src.parent.mkdir()
    fixtures.write_torch_checkpoint(str(src), 8, seed=31)
    tif = tmp_path / "img.tif"
    img = (np.random.default_rng(3).random((150, 170, 3)) * 65535).astype(np.uint16)
    assert cv2.imwrite(str(tif), img)
    seen = []
    encode = port_cli._encode_u8
    monkeypatch.setattr(port_cli, "_encode_u8",
                        lambda u8, path, q: seen.append(np.array(u8)) or encode(u8, path, q))
    _with_url(monkeypatch, src.as_uri())
    work = tmp_path / "work"
    for d in ("work", "fetched", "again", "direct"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(work)
    common = [str(tif), "--tiff-input", "-q", "95", "--device", "cpu"]

    out = port_cli.main(common + ["-o", str(tmp_path / "fetched")])
    fetched = work / TABLE_PATH
    assert no_network == [src.as_uri()]
    assert fetched.read_bytes() == src.read_bytes() and not _part(fetched).exists()
    assert out == tmp_path / "fetched" / "img.jpg" and out.is_file()

    port_cli.main(common + ["-o", str(tmp_path / "again")])
    assert no_network == [src.as_uri()], "a present checkpoint was fetched again"
    port_cli.main(common + ["-o", str(tmp_path / "direct"), "--model_path", str(src)])
    assert len(seen) == 3 and seen[0].shape == (150, 170, 3)
    assert np.array_equal(seen[0], seen[2]) and np.array_equal(seen[1], seen[2])
    assert no_network == [src.as_uri()]
