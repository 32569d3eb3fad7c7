"""BENCHMARK.json against the benchmark's contract, and every file that a
cell or a metric names found by that name."""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys

import pytest

from conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expan)")


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert line(word) and not word.startswith("/") and ".." not in word


def test_run_seconds_fits_the_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
        for n in names:
            assert NAME.match(n), n
        if group in ("end_to_end", "per_layer"):
            seen |= set(names)
    assert len(seen) == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_the_metrics_asked_for():
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "mp_per_s", "image_s_p90", "crops_per_s", "setup_s"}
    assert {m["name"] for m in SPEC["per_layer"]} == {
        "engine.denoise_ms", "rl.post_ms", "mfu.denoise", "k2_roofline", "k1_roofline",
        "idle.denoise", "mfu.train", "idle.train"}


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    files = set()
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p.rstrip("/") + "/" for p in SPEC["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)


def test_workloads_find_their_files():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "portbench" / "loops" / f"{traffic['loop']}.py").is_file()
        limits = json.loads((REPO / "portbench" / "limits" / f"{w['name']}.json").read_text())
        assert limits["numbers"] and all("limit" in v for v in limits["numbers"].values())
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def _reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_what_it_must():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if _reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in SPEC["per_layer"] if _reports(w["name"], m)]
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_per_layer_metrics_find_their_readers():
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        path = REPO / "portbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
        layers.setdefault(m["layer"].lower(), m["layer"])
    assert len(layers) == len(set(layers.values()))


def test_files_under_paths_are_named_from_names():
    for p in (REPO / "portbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_.-]+$", p.name), p


@pytest.mark.parametrize("tail", [["--workload", "utnet_f64.photos_6mp", "--seed", "1",
                                   "--seconds", "1", "--trace", "0"]])
def test_no_result_without_the_program_or_a_card(tmp_path, tail):
    """In a directory that holds only BENCHMARK.json and portbench/, or on
    a machine without CUDA, the command exits non-zero and prints no
    result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *SPEC["command"][1:], *tail], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
