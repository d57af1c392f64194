"""The PyTorch port stands alone: no file of sparsebit_tpu_torch/, no
port CLI (examples/llm/*_torch.py) and not chip_smoke.py imports jax or
the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "sparsebit_tpu_torch").rglob("*.py")) + sorted(
    (ROOT / "examples" / "llm").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "sparsebit_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, "{} imports {}".format(path.relative_to(ROOT), bad)


def test_import_check_catches_jax():
    assert _forbidden("jax.numpy") and _forbidden("sparsebit_tpu.ops")
    assert not _forbidden("sparsebit_tpu_torch.ops")
