"""On the card: each cell's control, in the program's place at a size a
test run holds, has to come out not correct under the cell's own limits,
and the program itself correct.

- utnet_f64.photos_6mp: the program's own int8 path (its next precision
  below bf16);
- unet.photos_6mp: the plain reference with every convolution's operands
  in float8 e4m3 (UNet has no int8 path);
- the training cells: the plain reference with TF32 on (the configuration
  states float32 with TF32 off).

Run on the machine with the card: ``python3 -m pytest portbench/tests -q -m card``.
"""

from __future__ import annotations

import json

import pytest

from portbench import bench, calibrate

CONTROLS = {"utnet_f64.photos_6mp": "program_int8", "unet.photos_6mp": "reference_fp8",
            "utnet_f64.train_std": "reference_tf32", "unet.train_std": "reference_tf32"}
SMALL = {"photos": {"pool": 2, "shape": [1000, 1500], "check_sample": 2},
         "train": {"pool": 512, "order_steps": 64}}


def small_cell(tmp_path, cell: str) -> tuple:
    """A copy with ``cell``'s traffic made small under a new name, its
    limits those of ``cell``."""
    import helpers

    root = helpers.copy_bench(tmp_path)
    b = bench.Benchmark(root)
    w = b.cell(cell)
    traffic = b.traffic(w)
    traffic.update(SMALL[traffic["loop"]])
    name = f"{w['traffic']}_small"
    (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (root / "portbench" / "limits" / f"{w['config']}.{name}.json").write_text(
        json.dumps(b.limits(w)))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(w, name=f"{w['config']}.{name}", traffic=name))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    b = bench.Benchmark(root)
    return b, b.cell(f"{w['config']}.{name}")


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_control_is_not_correct(card, tmp_path, cell):
    b, small = small_cell(tmp_path, cell)
    limits = b.limits(small)
    for seed in (2 ** 31 + 7, 2 ** 31 + 8):
        got = calibrate.one(b, small, seed, 1.0, control=CONTROLS[cell], device=card)
        checks = bench.compare(got["readings"], limits)
        assert not all(c["ok"] for c in checks.values()), got["readings"]


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_program_is_correct(card, tmp_path, cell):
    b, small = small_cell(tmp_path, cell)
    got = calibrate.one(b, small, 2 ** 31 + 9, 1.0, device=card)
    checks = bench.compare(got["readings"], b.limits(small))
    assert all(c["ok"] for c in checks.values()), got["readings"]
