"""A copy of the benchmark in a temporary directory, with tiny cells added
as files only, for runs on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "utnet_tiny": {
        "name": "utnet_tiny", "network": "UtNet", "funit": 8,
        "kwargs": {"funit": 8, "activation": "PReLU"},
        "source": "https://f005.backblazeb2.com/file/modelzoo/nind/generator_650.pt",
        "inference": {"compute_dtype": "float32", "cs": 104, "ucs": 88, "overlap": 6,
                      "batch_size": 4},
        "training": {"compute_dtype": "float32", "batch_size": 2, "cs": 168, "loss_cs": 168,
                     "loss_weights": {"MSSSIM": 1.0}, "lr": 1e-4, "beta1": 0.75},
        "reduced": ["funit"]},
    "unet_tiny": {
        "name": "unet_tiny", "network": "UNet", "funit": None, "kwargs": {},
        "source": "https://github.com/trougnouf/nind-denoise",
        "inference": {"compute_dtype": "float32", "cs": 64, "ucs": 48, "overlap": 6,
                      "batch_size": 4},
        "training": {"compute_dtype": "float32", "batch_size": 2, "cs": 48, "loss_cs": 40,
                     "loss_weights": {"MSE": 1.0}, "lr": 3e-4, "beta1": 0.5},
        "reduced": []},
}
TINY_TRAFFIC = {
    "photos_tiny": {"loop": "photos", "pool": 3, "shape": [120, 160], "portrait_every": 3,
                    "noise_sigmas": [0.02, 0.08], "scene_cells": 6, "texture_cells": 40,
                    "rl": {"psf": "gaussian", "sigma": 1.0, "iterations": 3},
                    "check_sample": 2, "trace_after": 1, "trace_items": 2},
    "train_tiny": {"loop": "train", "pool": 16, "noise_sigma_range": [0.01, 0.1],
                   "scene_cells": 4, "texture_cells": 20, "warm_steps": 2, "checked_steps": 3,
                   "order_steps": 64, "trace_after": 1, "trace_items": 2},
}
# float32 on the CPU against the reference, at these sizes: UNet's
# gradients read up to ~3e-3 apart by the check's measure (its BatchNorm
# backward over 2 x 48 x 48); the planted faults read 0.04-1
TINY_LIMITS = {
    "photos": {"canvas_rel_rms": 1e-4, "u8_rms_lsb": 0.5, "u8_over1_share": 1e-3,
               "u8_over2_block": 1e-3},
    "train": {"loss1_gap": 1e-5, "grad_multi_gap": 1e-2, "change_gap": 0.1},
}


def copy_bench(dst: Path) -> Path:
    """BENCHMARK.json and portbench/ copied, the program linked."""
    dst = Path(dst)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "nind_denoise_tpu_torch").symlink_to(REPO / "nind_denoise_tpu_torch")
    return dst


def add_cell(root: Path, config: str, traffic: str) -> str:
    """Add a tiny cell to the copy at ``root`` as new files and entries
    only; returns the cell's name."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = TINY_CONFIGS[config]
    cfg_file = f"portbench/configs/{config}.json"
    if not (root / cfg_file).exists():
        (root / cfg_file).write_text(json.dumps(cfg))
        spec["configs"].append({"name": config, "source": cfg["source"], "file": cfg_file,
                                "reduced": cfg["reduced"], "why": "a tiny copy for the CPU"})
    tr = TINY_TRAFFIC[traffic]
    (root / "portbench" / "traffic" / f"{traffic}.json").write_text(json.dumps(tr))
    name = f"{config}.{traffic}"
    limits = {k: {"limit": v} for k, v in TINY_LIMITS[tr["loop"]].items()}
    (root / "portbench" / "limits" / f"{name}.json").write_text(json.dumps({"numbers": limits}))
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                              "why": "a tiny cell for the CPU"})
    e2e = "mp_per_s" if tr["loop"] == "photos" else "crops_per_s"
    for m in spec["end_to_end"]:
        if m["name"] in (e2e, "image_s_p90") and (tr["loop"] == "photos" or m["name"] == e2e):
            m["workloads"].append(name)
    for m in spec["per_layer"]:
        if m["moves"] == e2e and m["name"] != "k2_roofline":
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return name
