"""The port's NIND downloader (``tools/dl_ds.py``) against the JAX package's.

A patched ``urllib.request.urlopen`` plays Wikimedia Commons: API queries
are answered from a dict (``categorymembers`` in pages, ``imageinfo`` with a
file's url and sha1), and file URLs serve bytes, some of them corrupt or
failing. Both packages run the same calls: the pinned manifest (byte-equal
copy, titles of both manifest forms, its 6 / 114 / 749 counts),
``scene_of``, ``list_category_files`` over ``continue``, ``file_info``'s
query, ``download_file``'s bounded retries, and ``main`` end to end, which
must write the same tree byte for byte and return the same code with the
same ``ERRORS:`` lines. Nothing leaves the machine."""

import hashlib
import io
import json
import os
import subprocess
import time
import urllib.parse
import urllib.request

import pytest
import yaml

from nind_denoise_tpu.tools import dl_ds as jax_dl
from nind_denoise_tpu_torch.tools import dl_ds as port_dl
from test_torch_download import _url_of, no_network  # noqa: F401 (autouse fixture)

SIDES = {"jax": jax_dl, "port": port_dl}
FILES = "https://upload.commons.test/"


class Commons:
    """Answers ``urlopen`` for the API (``API``) and for ``FILES``: ``files``
    maps a file name to its bytes, ``corrupt`` to the bytes served instead
    (the API still gives the true sha1), ``fail`` to a number of fetches
    that raise before one succeeds. ``members`` is the category's pages."""

    def __init__(self, files, corrupt=(), fail=None, members=None):
        self.files = dict(files)
        self.corrupt = dict(corrupt)
        self.fail = dict(fail or {})
        self.members = members or []
        self.requests = []

    def sha1(self, name):
        return hashlib.sha1(self.files[name]).hexdigest()

    def api(self, q):
        if q.get("list") == "categorymembers":
            page = int(q.get("cmcontinue", "0"))
            res = {"query": {"categorymembers": [{"title": t} for t in self.members[page]]}}
            if page + 1 < len(self.members):
                res["continue"] = {"cmcontinue": str(page + 1), "continue": "-||"}
            return res
        name = q["titles"].split(":", 1)[1]
        if name not in self.files:
            return {"query": {"pages": {"-1": {"title": q["titles"], "missing": ""}}}}
        info = {"url": FILES + name, "sha1": self.sha1(name),
                "timestamp": "2020-01-01T00:00:00Z"}
        return {"query": {"pages": {"7": {"title": q["titles"], "imageinfo": [info]}}}}

    def __call__(self, req, *a, **kw):
        url = _url_of(req)
        self.requests.append(url)
        if url.startswith(jax_dl.API + "?"):
            q = dict(urllib.parse.parse_qsl(url.split("?", 1)[1]))
            assert q.pop("format") == "json"
            return io.BytesIO(json.dumps(self.api(q)).encode())
        assert url.startswith(FILES), url
        name = url[len(FILES):]
        if self.fail.get(name, 0) > 0:
            self.fail[name] -= 1
            raise ConnectionResetError("reset by the test")
        return io.BytesIO(self.corrupt.get(name, self.files[name]))

    def fetches(self):
        return [u for u in self.requests if u.startswith(FILES)]


@pytest.fixture
def sleeps(monkeypatch):
    seen = []
    monkeypatch.setattr(time, "sleep", seen.append)
    return seen


def _serve(monkeypatch, commons):
    monkeypatch.setattr(urllib.request, "urlopen", commons)
    return commons


def test_manifest_is_a_byte_equal_copy():
    with open(jax_dl.DEFAULT_MANIFEST, "rb") as a, open(port_dl.DEFAULT_MANIFEST, "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(port_dl.DEFAULT_MANIFEST) == os.path.join(
        os.path.dirname(os.path.abspath(port_dl.__file__)), "manifests")


def test_pinned_manifest_counts_and_titles():
    with open(port_dl.DEFAULT_MANIFEST) as fp:
        man = yaml.safe_load(fp)
    assert man["last_update"] == "2021-05-21" and len(man["sets"]) == 6
    assert sum(len(s["scenes"]) for s in man["sets"].values()) == 114
    titles = port_dl.manifest_titles(man)
    assert len(titles) == 749 and titles == jax_dl.manifest_titles(man)
    assert "NIND_bananapi_ISO50.png" in titles
    assert "NIND_MuseeL-yombe_ISO200.jpg" in titles


def test_manifest_titles_legacy_flat_form():
    man = {"bananapi": ["NIND_bananapi_ISO50.png", "NIND_bananapi_ISO6400.png"],
           "Pen-pile": ["File:NIND_Pen-pile_ISOH1.jpg"], "empty": []}
    assert port_dl.manifest_titles(man) == jax_dl.manifest_titles(man) == [
        "NIND_bananapi_ISO50.png", "NIND_bananapi_ISO6400.png", "File:NIND_Pen-pile_ISOH1.jpg"]


def test_constants_match():
    for name in ("API", "DEFAULT_CATEGORY", "MAX_ATTEMPTS"):
        assert getattr(port_dl, name) == getattr(jax_dl, name)
    assert port_dl.MAX_ATTEMPTS == 3


@pytest.mark.parametrize("name", [
    "NIND_MuseeL-Bobo-C500D_ISOH1.jpg", "NIND_bananapi_ISO50.png",
    "NIND_ursulines-red_ISO6400.png", "NIND_Pen-pile_ISO200.jpg",
    "NIND_a_b_c_ISO100.png", "NIND_x.png", "NIND_ISO50.png", "NIND_.png",
    "IMG_1234.jpg", "nind_bananapi_ISO50.png", "bananapi_ISO50.png",
    "NIND_noext_ISO50", "README", ""])
def test_scene_of_matches_jax(name):
    assert port_dl.scene_of(name) == jax_dl.scene_of(name)


def test_list_category_files_follows_continue(monkeypatch):
    pages = [["File:NIND_a_ISO100.png", "File:NIND_a_ISO200.png"],
             ["File:NIND_b_ISOH1.jpg"]]
    got = {}
    for side, mod in SIDES.items():
        commons = _serve(monkeypatch, Commons({}, members=pages))
        got[side] = (list(mod.list_category_files(mod.DEFAULT_CATEGORY)), commons.requests)
    assert got["port"] == got["jax"]
    titles, requests = got["port"]
    assert titles == pages[0] + pages[1] and len(requests) == 2
    assert "cmcontinue=1" in requests[1] and "cmcontinue" not in requests[0]


@pytest.mark.parametrize("datelimit", [None, "2021-05-21"])
def test_file_info_builds_the_same_query(monkeypatch, datelimit):
    files = {"NIND_a_ISO100.png": b"pixels"}
    got = {}
    for side, mod in SIDES.items():
        commons = _serve(monkeypatch, Commons(files))
        got[side] = (mod.file_info("File:NIND_a_ISO100.png", datelimit), commons.requests)
    assert got["port"] == got["jax"]
    (url, sha1), (request,) = got["port"]
    assert (url, sha1) == (FILES + "NIND_a_ISO100.png", hashlib.sha1(b"pixels").hexdigest())
    q = dict(urllib.parse.parse_qsl(request.split("?", 1)[1]))
    assert q["iiprop"] == "timestamp|url|sha1" and q["prop"] == "imageinfo"
    assert q.get("iistart") == (None if datelimit is None else "2021-05-21T23:59:59Z")


# name -> (Commons kwargs, expected return, expected fetches, expected sleeps)
DOWNLOADS = {
    "success": ({}, True, 1, []),
    "sha1_mismatch": ({"corrupt": {"f.png": b"bad"}}, False, 3, [1, 1, 1]),
    "exception_then_success": ({"fail": {"f.png": 1}}, True, 2, [2]),
    "exception_every_time": ({"fail": {"f.png": 9}}, False, 3, [2, 2, 2]),
}


@pytest.mark.parametrize("case", sorted(DOWNLOADS))
def test_download_file_retries(tmp_path, monkeypatch, sleeps, case):
    kwargs, ok, n_fetch, n_sleeps = DOWNLOADS[case]
    data = bytes(range(256)) * 9000  # over two 1 MiB chunks
    got = {}
    for side, mod in SIDES.items():
        commons = _serve(monkeypatch, Commons({"f.png": data}, **kwargs))
        dest = tmp_path / side / "f.png"
        dest.parent.mkdir()
        del sleeps[:]
        res = mod.download_file(FILES + "f.png", str(dest), commons.sha1("f.png"))
        assert not os.path.exists(str(dest) + ".part")
        got[side] = (res, len(commons.fetches()), list(sleeps),
                     dest.read_bytes() if dest.exists() else None)
    assert got["port"] == got["jax"] == (ok, n_fetch, n_sleeps, data if ok else None)


SETS = {
    "last_update": "2021-05-21",
    "sets": {
        "X-T1": {"ext": "png", "scenes": {"bananapi": [100, 6400], "Pen-pile": [200, "H1"]}},
        "C500D": {"ext": "jpg", "scenes": {"MuseeL-Bobo-C500D": ["H1", 1600]}},
    },
}


def _bytes_of(title):
    return hashlib.sha256(title.encode()).digest() * 37


def _run_main(tmp_path, monkeypatch, capsys, side, manifest, commons, extra=(),
              existing=None):
    target = tmp_path / side / "NIND"
    mpath = tmp_path / side / "manifest.yaml"
    mpath.parent.mkdir(parents=True, exist_ok=True)
    mpath.write_text(yaml.safe_dump(manifest))
    for rel, data in (existing or {}).items():
        os.makedirs(target / os.path.dirname(rel), exist_ok=True)
        (target / rel).write_bytes(data)
    _serve(monkeypatch, commons)
    capsys.readouterr()
    rc = SIDES[side].main(["--target_dir", str(target), "--manifest", str(mpath), *extra])
    out = capsys.readouterr().out
    tree = {os.path.relpath(os.path.join(d, f), target): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(target) for f in fs}
    errors = out.split("ERRORS:\n", 1)[1].splitlines() if "ERRORS:" in out else None
    return rc, tree, errors, commons


def _titles(manifest):
    return port_dl.manifest_titles(manifest)


def test_main_downloads_the_pinned_sets(tmp_path, monkeypatch, capsys, sleeps):
    files = {t: _bytes_of(t) for t in _titles(SETS)}
    got = {side: _run_main(tmp_path, monkeypatch, capsys, side, SETS, Commons(files))[:3]
           for side in SIDES}
    assert got["port"] == got["jax"]
    rc, tree, errors = got["port"]
    assert rc == 0 and errors is None and len(tree) == 6
    assert tree[os.path.join("MuseeL-Bobo-C500D", "NIND_MuseeL-Bobo-C500D_ISOH1.jpg")] == \
        files["NIND_MuseeL-Bobo-C500D_ISOH1.jpg"]
    assert sleeps == []


def test_main_pins_revisions_to_the_manifest_date(tmp_path, monkeypatch, capsys, sleeps):
    files = {t: _bytes_of(t) for t in _titles(SETS)}
    for side in SIDES:
        for extra, date in (((), "2021-05-21"), (("--datelimit", "2020-02-02"), "2020-02-02")):
            commons = Commons(files)
            _run_main(tmp_path / date, monkeypatch, capsys, side, SETS, commons, extra)
            info = [u for u in commons.requests if "prop=imageinfo" in u]
            assert len(info) == 6 and all(f"iistart={date}T23" in u for u in info)


def test_main_collects_errors(tmp_path, monkeypatch, capsys, sleeps):
    """A corrupt file after MAX_ATTEMPTS tries, a title Commons does not
    know and a name that is not NIND's: exit 1, the same ERRORS lines, and
    every other file written."""
    manifest = {"a": ["NIND_a_ISO100.png", "NIND_a_ISO200.png", "IMG_0001.jpg"],
                "b": ["File:NIND_b_ISO100.png", "NIND_gone_ISO100.png"]}
    files = {t.split(":")[-1]: _bytes_of(t) for t in _titles(manifest) if "gone" not in t}
    got = {}
    for side in SIDES:
        commons = Commons(files, corrupt={"NIND_a_ISO200.png": b"corrupt"})
        rc, tree, errors, commons = _run_main(tmp_path, monkeypatch, capsys, side,
                                              manifest, commons)
        got[side] = (rc, tree, errors, len(commons.fetches()))
    assert got["port"] == got["jax"]
    rc, tree, errors, n_fetch = got["port"]
    assert rc == 1 and n_fetch == 2 + port_dl.MAX_ATTEMPTS
    assert sorted(tree) == [os.path.join("a", "NIND_a_ISO100.png"),
                            os.path.join("b", "NIND_b_ISO100.png")]
    assert errors[0] == "NIND_a_ISO200.png: download failed"
    assert errors[1].startswith("NIND_gone_ISO100.png: info failed") and len(errors) == 2


def test_main_skip_existing_fetches_nothing(tmp_path, monkeypatch, capsys, sleeps):
    files = {t: _bytes_of(t) for t in _titles(SETS)}
    good = os.path.join("bananapi", "NIND_bananapi_ISO100.png")
    stale = os.path.join("Pen-pile", "NIND_Pen-pile_ISO200.png")
    existing = {good: files["NIND_bananapi_ISO100.png"], stale: b"stale"}
    got = {}
    for side in SIDES:
        rc, tree, errors, commons = _run_main(tmp_path, monkeypatch, capsys, side, SETS,
                                              Commons(files), existing=existing)
        got[side] = (rc, tree, errors, sorted(commons.fetches()))
        again = _run_main(tmp_path, monkeypatch, capsys, side, SETS, Commons(files),
                          ("--skip_existing",))
        assert again[:3] == got[side][:3] and again[3].fetches() == []
    assert got["port"] == got["jax"]
    rc, tree, errors, fetched = got["port"]
    assert rc == 0 and len(tree) == 6 and tree[stale] == files["NIND_Pen-pile_ISO200.png"]
    assert len(fetched) == 5 and FILES + "NIND_bananapi_ISO100.png" not in fetched


def test_main_use_wget(tmp_path, monkeypatch, capsys, sleeps):
    """``--use_wget`` shells out (``subprocess.run`` patched: the stand-in
    writes the served bytes to ``-O``) and checks the sha1 afterwards."""
    files = {t: _bytes_of(t) for t in _titles(SETS)}
    corrupt = {"NIND_bananapi_ISO6400.png": b"corrupt"}
    runs = []

    def wget(argv, *a, **kw):
        runs.append(argv)
        assert argv[:3] == ["wget", "-q", "-O"]
        name = argv[4][len(FILES):]
        with open(argv[3], "wb") as f:
            f.write(corrupt.get(name, files.get(name, b"")))
        return subprocess.CompletedProcess(argv, 0 if name != "NIND_Pen-pile_ISOH1.png" else 8)

    monkeypatch.setattr(subprocess, "run", wget)
    got = {}
    for side in SIDES:
        del runs[:]
        rc, tree, errors, commons = _run_main(tmp_path, monkeypatch, capsys, side, SETS,
                                              Commons(files), ("--use_wget",))
        got[side] = (rc, tree, errors, len(runs), commons.fetches())
    assert got["port"] == got["jax"]
    rc, tree, errors, n_runs, fetched = got["port"]
    assert rc == 1 and n_runs == 6 and fetched == [] and len(tree) == 6
    # the manifest file's order: safe_dump sorts the sets and the scenes
    assert errors == ["NIND_Pen-pile_ISOH1.png: download failed",
                      "NIND_bananapi_ISO6400.png: download failed"]
