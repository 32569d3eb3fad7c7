"""A later change adds a cell and a metric as new files and entries only:
in a copy, tiny cells (a configuration, a traffic mix, its limits) and a
new per-layer metric are added that way and run through the harness on
the CPU, untraced and traced."""

from __future__ import annotations

import json

import pytest

from portbench import bench

NEW_METRIC = '''"""images.count: how many images the traced window finished."""


def read(ctx):
    return float(ctx.work["images"]) if "images" in ctx.work else None
'''


@pytest.mark.parametrize("index", range(4), ids=["utnet.photos", "utnet.train", "unet.photos",
                                                 "unet.train"])
def test_new_cell_runs_from_files(tiny_root, index):
    root, names = tiny_root
    name = names[index]
    spec = json.loads((root / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in spec["end_to_end"] if name in m.get("workloads", [name])}
    res, lines, _ = bench.run_cell(root, name, 2 ** 31 + 12345, 0.5, False, device="cpu")
    assert res["correct"], lines
    assert set(res["metrics"]) == e2e
    assert list(res)[-1] == "checks" and lines
    res, _, _ = bench.run_cell(root, name, 2 ** 31 + 12345, 0.5, True, device="cpu")
    assert res["correct"] and res["metrics"]
    assert "busy_s" in res["device"] and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_metric_from_a_file(tiny_root):
    root, names = tiny_root
    cell = names[0]  # utnet_tiny.photos_tiny
    (root / "portbench" / "metrics" / "images.count.py").write_text(NEW_METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "images.count", "unit": "images", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "mp_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res, _, _ = bench.run_cell(root, cell, 77, 0.5, True, device="cpu")
    assert res["metrics"]["images.count"]["value"] >= 3
    # a metric whose reader finds nothing is left out of the line
    res, _, _ = bench.run_cell(root, names[1], 77, 0.5, True, device="cpu")
    assert "images.count" not in res["metrics"]
