"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under portbench/ (top-level module names compared whole, since
the port's name begins with the JAX package's), and nothing of the
program in the plain reference."""

from __future__ import annotations

import ast
import sys

import pytest

from conftest import REPO

BANNED = {"jax", "jaxlib", "flax", "nind_denoise_tpu"}
PROGRAM = "nind_denoise_tpu_torch"
FILES = sorted(p for p in (REPO / "portbench").rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every absolute import, and the relative imports
    as (level, module)."""
    names, relative = set(), []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                relative.append((node.level, node.module or ""))
            else:
                names.add(node.module.split(".")[0])
    return names, relative


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax(path):
    names, _ = imported(path)
    assert not names & BANNED, f"{path} imports {names & BANNED}"


@pytest.mark.parametrize("path", sorted((REPO / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names, relative = imported(path)
    assert PROGRAM not in names
    # relative imports stay inside reference/
    assert all(level == 1 for level, _ in relative), relative


def test_run_refuses_banned_modules(monkeypatch):
    from portbench import bench

    assert bench.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "nind_denoise_tpu.models", object())
    assert bench.banned_modules() == ["jaxlib", "nind_denoise_tpu"]


def test_the_port_is_not_banned(monkeypatch):
    from portbench import bench

    monkeypatch.setitem(sys.modules, "nind_denoise_tpu_torch.models", object())
    assert bench.banned_modules() == []
