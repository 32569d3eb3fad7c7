"""Small host-side file/JSON helpers: a copy of
``nind_denoise_tpu/utils/utilities.py``.

Capability parity with the reference's ``common/libs/utilities.py``
(the reference's src/nind_denoise/common/libs/utilities.py:1-120), re-written
for this framework.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import shutil
import statistics
from typing import Dict, Iterable, List, Optional, Sequence


def checksum(fpath: str, htype: str = "sha1") -> str:
    """Streaming file checksum (sha1/sha256)."""
    try:
        h = hashlib.new(htype)
    except ValueError as e:
        raise NotImplementedError(htype) from e
    with open(fpath, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cp(inpath: str, outpath: str) -> None:
    """Copy with reflink when the filesystem supports it."""
    try:
        import subprocess

        subprocess.run(("cp", "--reflink=auto", inpath, outpath), check=True)
    except (FileNotFoundError, Exception):
        shutil.copy2(inpath, outpath)


def jsonfpath_load(fpath: str, default_type=dict, default=None):
    """Load JSON; integer-looking keys are converted back to int (epochs)."""
    if not os.path.isfile(fpath):
        return default_type() if default is None else default

    def keys2int(x):
        if isinstance(x, dict):
            return {int(k) if isinstance(k, str) and k.isdigit() else k: v for k, v in x.items()}
        return x

    with open(fpath, "r") as f:
        return json.load(f, object_hook=keys2int)


def dict_to_json(adict: dict, fpath: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
    with open(fpath, "w") as f:
        json.dump(adict, f, indent=2)


def get_leaf(path: str) -> str:
    """Basename of a path, tolerant of trailing separators."""
    return os.path.basename(os.path.normpath(path))


def get_root(fpath: str) -> str:
    """Directory containing ``fpath``."""
    return os.path.dirname(os.path.normpath(fpath))


def avg_listofdicts(listofdicts: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Average each key across a list of dicts (reference bug fixed: it
    forgot to return)."""
    if not listofdicts:
        return {}
    res: Dict[str, List[float]] = {k: [] for k in listofdicts[0]}
    for d in listofdicts:
        for k, v in d.items():
            res.setdefault(k, []).append(v)
    return {k: statistics.mean(v) for k, v in res.items()}


def list_of_tuples_to_csv(rows: Iterable[tuple], heading: Sequence[str], fpath: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
    with open(fpath, "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(heading)
        for row in rows:
            w.writerow(row)


def filesize(fpath: str) -> int:
    return os.stat(fpath).st_size
