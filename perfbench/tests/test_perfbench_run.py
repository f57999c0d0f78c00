"""``run.py`` refuses to give a result without a card or without the system
under test, and finds JAX or the JAX package by whole top-level names."""

from __future__ import annotations

import shutil
import subprocess
import sys
import types

import pytest

from perfbench import run

ROOT = run.ROOT
ARGS = ["--workload", "cohere768-10m.batch", "--seed", "5", "--seconds", "1", "--trace", "0"]


def test_no_card_exits_nonzero_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), *ARGS],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_unknown_cell_exits_nonzero():
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", "nope",
                        "--seed", "1", "--seconds", "1"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == "" and "nope" in p.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files: past
    the look for a card, the system under test is not there to import."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = (
        "import sys, torch; sys.argv[1:] = %r; sys.path.insert(0, %r)\n"
        "from perfbench import run\n"
        "run.require_device = lambda chips: torch.device('cpu')\n"
        "raise SystemExit(run.main(sys.argv[1:]))\n" % (ARGS, str(tmp_path))
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "does not import" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hyperdb_tpu_torch_like", types.ModuleType("hyperdb_tpu_torch_like"))
    assert "hyperdb_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hyperdb_tpu.ops", types.ModuleType("hyperdb_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["hyperdb_tpu", "jax"]


def test_the_harness_and_reference_import_nothing_forbidden():
    """The benchmark's sources name no module of JAX or the JAX package, and
    the reference none of the program either."""
    import ast

    for path in (ROOT / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in run.FORBIDDEN, (path, name)
                if "reference" in path.parts:
                    assert top in ("torch", "numpy", "__future__"), (path, name)
