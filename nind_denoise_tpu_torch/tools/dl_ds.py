"""NIND dataset downloader (Wikimedia Commons).

Counterpart of ``nind_denoise_tpu/tools/dl_ds.py`` (the reference's
tools/dl_ds_1.py:1-236), on the host with the standard library's urllib.
By default it targets the same date-pinned snapshot the reference hardcodes
(dl_ds_1.py:12-146): the port's own copy of the manifest
``manifests/nind_2021-05-21.yaml`` (114 scenes / 749 files across 6 camera
sets) with each file resolved to its latest Commons revision on or before
``last_update``, so a no-argument run reproduces the exact reference
dataset. Alternatives: ``--manifest`` for another snapshot yaml, or
``--category`` for a live category query (not reproducible). Shared
behavior: sha1 verification against the Commons API, bounded retries, error
accumulation with a nonzero exit, and the
``NIND/<scene>/NIND_<scene>_ISO<val>.<ext>`` output layout.

    python -m nind_denoise_tpu_torch.tools.dl_ds --target_dir <datasets>/NIND
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.parse
import urllib.request
from typing import Dict, Iterator, List, Optional, Tuple

import yaml

from ..utils import utilities

API = "https://commons.wikimedia.org/w/api.php"
DEFAULT_CATEGORY = "Category:Natural_Image_Noise_Dataset"
DEFAULT_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "manifests", "nind_2021-05-21.yaml")
MAX_ATTEMPTS = 3


def _api(params: Dict) -> Dict:
    params = dict(params, format="json")
    url = API + "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, headers={"User-Agent": "nind-denoise-tpu/0.1"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read().decode())


def list_category_files(category: str) -> Iterator[str]:
    cont = {}
    while True:
        res = _api({"action": "query", "list": "categorymembers",
                    "cmtitle": category, "cmtype": "file", "cmlimit": "500",
                    **cont})
        for m in res["query"]["categorymembers"]:
            yield m["title"]  # "File:NIND_<scene>_ISO<val>.<ext>"
        if "continue" not in res:
            return
        cont = res["continue"]


def file_info(title: str, datelimit: Optional[str] = None) -> Tuple[str, str]:
    """-> (download url, sha1). ``datelimit`` (YYYY-MM-DD) pins the latest
    revision uploaded on or before that date (dl_ds_1.py:160 iistart)."""
    params = {"action": "query", "titles": title, "prop": "imageinfo",
              "iiprop": "timestamp|url|sha1"}
    if datelimit:
        params["iistart"] = datelimit + "T23:59:59Z"
    res = _api(params)
    page = next(iter(res["query"]["pages"].values()))
    ii = page["imageinfo"][0]
    return ii["url"], ii["sha1"]


def manifest_titles(manifest: Dict) -> List[str]:
    """Expand a manifest into Commons file titles.

    Pinned-snapshot format ({last_update, sets: {set: {ext, scenes:
    {scene: [iso...]}}}}) or the legacy flat {scene: [titles]} form.
    """
    if "sets" in manifest:
        return [f"NIND_{scene}_ISO{iso}.{s['ext']}"
                for s in manifest["sets"].values()
                for scene, isos in s["scenes"].items()
                for iso in isos]
    return [f for files in manifest.values() for f in files]


def scene_of(filename: str) -> Optional[str]:
    # NIND_<scene>_ISO<val>.<ext>
    stem = filename.rsplit(".", 1)[0]
    parts = stem.split("_")
    if len(parts) < 3 or parts[0] != "NIND":
        return None
    return "_".join(parts[1:-1])


def download_file(url: str, dest: str, sha1: Optional[str]) -> bool:
    for attempt in range(MAX_ATTEMPTS):
        try:
            req = urllib.request.Request(
                url, headers={"User-Agent": "nind-denoise-tpu/0.1"})
            with urllib.request.urlopen(req) as r, open(dest + ".part", "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            if sha1 and utilities.checksum(dest + ".part", "sha1") != sha1:
                print(f"sha1 mismatch for {dest} (attempt {attempt + 1})")
                os.unlink(dest + ".part")
                time.sleep(1)
                continue
            os.replace(dest + ".part", dest)
            return True
        except Exception as e:
            print(f"download failed for {url}: {e} (attempt {attempt + 1})")
            time.sleep(2)
    return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target_dir", default=os.path.join("..", "..", "datasets", "NIND"))
    p.add_argument("--category", default=None,
                   help=f"query a Commons category live instead of the pinned "
                        f"manifest (e.g. {DEFAULT_CATEGORY}; not reproducible)")
    p.add_argument("--manifest", default=DEFAULT_MANIFEST,
                   help="snapshot YAML (default: the reference-pinned "
                        "2021-05-21 NIND manifest)")
    p.add_argument("--datelimit", default=None,
                   help="latest upload date for revision pinning "
                        "(default: the manifest's last_update)")
    p.add_argument("--use_wget", action="store_true",
                   help="shell out to wget instead of urllib")
    p.add_argument("--skip_existing", action="store_true", default=True)
    args = p.parse_args(argv)

    datelimit = args.datelimit
    if args.category:
        titles = list(list_category_files(args.category))
    else:
        with open(args.manifest) as fp:
            manifest = yaml.safe_load(fp)
        titles = manifest_titles(manifest)
        if datelimit is None:
            datelimit = manifest.get("last_update")
    print(f"{len(titles)} files to download"
          + (f" (revisions pinned to {datelimit})" if datelimit else ""))

    errors: List[str] = []
    for title in titles:
        fn = title.split(":", 1)[-1].replace(" ", "_")
        scene = scene_of(fn)
        if scene is None:
            print(f"skipping unrecognized name {fn}")
            continue
        dest_dir = os.path.join(args.target_dir, scene)
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, fn)
        try:
            url, sha1 = file_info(title if title.startswith("File:")
                                  else "File:" + title, datelimit)
        except Exception as e:
            errors.append(f"{title}: info failed ({e})")
            continue
        if os.path.isfile(dest) and args.skip_existing \
                and utilities.checksum(dest, "sha1") == sha1:
            continue
        if args.use_wget:
            import subprocess

            ok = subprocess.run(["wget", "-q", "-O", dest, url]).returncode == 0
            ok = ok and (not sha1 or utilities.checksum(dest, "sha1") == sha1)
        else:
            ok = download_file(url, dest, sha1)
        if not ok:
            errors.append(f"{title}: download failed")
        else:
            print(f"ok: {dest}")
    if errors:
        print("\n".join(["ERRORS:"] + errors))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
