"""What the benchmark may load: nothing of JAX or the JAX package, in its
sources or in a run's process; the references nothing of the port; and
nothing reads the JAX-era benchmark folder."""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import _tiny

SOURCES = sorted(p for p in _tiny.PB.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops


def test_references_import_nothing_of_the_port():
    for path in (_tiny.PB / "reference").glob("*.py"):
        for m in _imports(path):
            assert m.split(".")[0] in {"torch", "numpy", "math",
                                       "contextlib", "__future__"} or \
                m.startswith("portbench.reference"), (path.name, m)


def test_nothing_reads_the_jax_era_benchmark():
    jax_era = re.compile(r"\b" + "bench" + r"marks\b|BENCH_" + "baseline"
                         + r"|bench_" + "gate")
    me = os.path.basename(__file__)
    for path in _tiny.PB.rglob("*"):
        if path.is_file() and path.name != me and "__pycache__" \
                not in path.parts:
            assert not jax_era.search(path.read_text()), path


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process: afterwards its modules hold
    neither JAX nor the JAX package, compared by whole top-level names
    (the port's name begins with the JAX package's), and do hold the
    port."""
    pb = _tiny.tree(tmp_path)
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        f"r = harness.run('tiny-flat-cell', seed=5, seconds=0.4, "
        f"traced=False, device='cpu', pb=Path({str(pb)!r}))\n"
        "print(json.dumps({'found': harness.forbidden_modules(), "
        "'port': 'repro_torch' in sys.modules, 'ok': r['correct']}))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_tiny.ROOT), str(_tiny.ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"found": [], "port": True, "ok": True}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "flat4m-backlog",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=_tiny.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
