"""Nothing under benchmark/ imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's),
and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from benchmark.tests.conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "sparsebit_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_no_jax_anywhere_under_benchmark():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _imports(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        top = _imports(f)
        assert "sparsebit_tpu_torch" not in top, f
        assert not {t for t in top if t == "benchmark"}, f


def test_runtime_check_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "sparsebit_tpu_torch_x.y", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "sparsebit_tpu.llm", object())
    assert set(run.forbidden_modules()) == before | {"jax.numpy",
                                                     "sparsebit_tpu.llm"}


def test_refuses_without_cuda_and_prints_no_result():
    code = ("import torch; torch.cuda.is_available = lambda: False; "
            "import runpy, sys; sys.argv = ['benchmark/run.py', "
            "'--workload', 'mistral7b-w4g128-chat', '--seed', '2147483659',"
            " '--seconds', '1', '--trace', '0']; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                       text=True, timeout=120)
    assert p.returncode == 2
    assert p.stdout == ""
    assert "CUDA" in p.stderr
