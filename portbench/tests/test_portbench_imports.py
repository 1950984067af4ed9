"""What the benchmark loads and reads: no JAX and no JAX package in a
run's process (top-level module names compared whole), nothing of
``benchmarks/`` or the JAX package's ``BENCH_*.json``; and a run exits
non-zero with no result without a card or without the port."""

import json
import shutil
import subprocess
import sys

import pytest

import small
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import small
res = small.run("{cell}", seconds=0.0)
assert res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", small.CELLS)
def test_a_run_loads_no_jax_and_no_jax_package(cell):
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                        tests=str(ROOT / "portbench" / "tests"), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_source_reads_the_jax_packages_benchmarks():
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in ("benchmarks/", "BENCH_", "import jax", "from jax",
                     "import repro\n", "from repro.", "from repro import"):
            assert word not in text, (path, word)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "glm4-9b.fine-hotness", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "glm4-9b.fine-hotness", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
