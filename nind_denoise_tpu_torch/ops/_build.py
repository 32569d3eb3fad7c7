"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>_<hash>.so``
at the repository root, then loaded with ``ctypes``. The file name carries
a hash of the source and the flags, so an unchanged tree never rebuilds.
Nothing here runs at import: the first launch builds. ``build_all`` starts
one ``nvcc`` per source, all at once. A failed build raises; there is no
fallback.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
``check`` raises when that is not 0. A wrapper calls its entry point inside
``on_device(tensor)``: ``ctypes`` launches on whatever device the calling
thread has current, and torch switches devices only inside its own ops, so
a launch for a ``cuda:1`` tensor would otherwise run with device 0 current.
Wrappers add to their ``launches`` count under ``COUNT_LOCK`` (the engines
of ``parallel/`` launch from one thread per device).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, target, temporary output)."""
    so = _target(name)
    if so.is_file():
        return None, so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so, tmp


def _finish(name: str, proc, so: Path, tmp) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> None:
    """Compile every ``csrc/*.cu`` that is not built yet, in parallel."""
    started = {n: _start(n) for n in sources()}
    for n, (proc, so, tmp) in started.items():
        _finish(n, proc, so, tmp)


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each C entry point to its ctypes argtypes (every
    entry returns an int error code)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def on_device(t):
    """Context manager that makes ``t``'s CUDA device current."""
    import torch

    return torch.cuda.device(t.device)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
