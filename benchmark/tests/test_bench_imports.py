"""Nothing that the benchmark imports or holds after a run is JAX or the
JAX package (top-level names compared whole: the port's name begins with
the JAX package's); the reference imports nothing of the port either; a
run with no card, or without the port in its checkout, fails."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

from .conftest import MESH, ROOT, copy_checkout

FORBIDDEN = {"jax", "jaxlib", "flax", "obj2voxel_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_no_source_of_the_benchmark_imports_jax():
    files = list((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        top = _imports(path)
        assert "obj2voxel_tpu_torch" not in top and not top & FORBIDDEN, path
        assert "benchmark" not in top, path
        assert "obj2voxel_tpu" not in path.read_text().replace("obj2voxel_tpu_torch", ""), path


def test_whole_names_are_compared(monkeypatch):
    from benchmark.harness.cell import FORBIDDEN as NAMES, forbidden_modules

    assert set(NAMES) == FORBIDDEN
    import obj2voxel_tpu_torch  # noqa: F401  the port's name begins with the JAX package's

    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "obj2voxel_tpu.engine", object())
    assert forbidden_modules() == ["obj2voxel_tpu.engine"]


def test_nothing_forbidden_after_a_run(tmp_path):
    copy_checkout(tmp_path)
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.harness import cell\n"
        f"r = cell.run_cell({str(tmp_path)!r}, {MESH!r}, 9, 0.2, False, 'cpu')\n"
        "print(json.dumps([r['correct'], sorted({m.split('.')[0] for m in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    correct, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert "obj2voxel_tpu_torch" in tops and not set(tops) & FORBIDDEN


def test_run_without_a_card_fails(no_card):
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          MESH, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_run_without_the_port_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", MESH,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "obj2voxel_tpu_torch" in out.stderr
