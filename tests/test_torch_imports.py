"""The PyTorch port stands alone: no file of sparsebit_tpu_torch/, no
port CLI (examples/**/*_torch.py) and not chip_smoke.py imports jax or
the JAX package; and every module of the port imports in a process where
jax, the JAX package and PyYAML cannot be imported (the card's machine
has no PyYAML: the config tree imports it only to read or write yaml)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "sparsebit_tpu_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").rglob("*_torch.py")) + [ROOT / "chip_smoke.py"]


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


MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "")
    for p in (ROOT / "sparsebit_tpu_torch").rglob("*.py"))


def test_every_port_module_imports_without_jax_or_yaml():
    blocked = ("jax", "jaxlib", "sparsebit_tpu", "yaml")
    code = ("import importlib, sys\n"
            "for name in {!r}:\n"
            "    sys.modules[name] = None\n"
            "for mod in {!r}:\n"
            "    importlib.import_module(mod)\n"
            "print(len({!r}))\n").format(blocked, MODULES, MODULES)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(len(MODULES))
    for new in ("sparsebit_tpu_torch.llm.offload",
                "sparsebit_tpu_torch.quantization.fake_quant",
                "sparsebit_tpu_torch.quantization.observers.percentile",
                "sparsebit_tpu_torch.quantization.quantizers.lsq_plus",
                "sparsebit_tpu_torch.utils.config",
                "sparsebit_tpu_torch.nn.graph",
                "sparsebit_tpu_torch.models.resnet",
                "sparsebit_tpu_torch.quantization.quant_model",
                "sparsebit_tpu_torch.quantization.observers.kl_device",
                "sparsebit_tpu_torch.quantization.quantizers.adaround",
                "sparsebit_tpu_torch.quantization.tools.fixture",
                "sparsebit_tpu_torch.sparse",
                "sparsebit_tpu_torch.sparse.sparse_config",
                "sparsebit_tpu_torch.sparse.sparse_model",
                "sparsebit_tpu_torch.sparse.sparsers.base",
                "sparsebit_tpu_torch.sparse.sparsers.random",
                "sparsebit_tpu_torch.sparse.sparsers.slimming",
                "sparsebit_tpu_torch.sparse.modules.base",
                "sparsebit_tpu_torch.sparse.modules.normalization",
                "sparsebit_tpu_torch.models.mobilenet",
                "sparsebit_tpu_torch.models.efficientnet",
                "sparsebit_tpu_torch.models.regnet",
                "sparsebit_tpu_torch.models.gpt2",
                "sparsebit_tpu_torch.models.yolo",
                "sparsebit_tpu_torch.models.bevdet",
                "sparsebit_tpu_torch.models.import_torch",
                "sparsebit_tpu_torch.utils.profiling",
                "sparsebit_tpu_torch.parallel",
                "sparsebit_tpu_torch.parallel.mesh",
                "sparsebit_tpu_torch.parallel.multihost",
                "sparsebit_tpu_torch.parallel.tp",
                "sparsebit_tpu_torch.parallel.sp",
                "sparsebit_tpu_torch.parallel.pp",
                "sparsebit_tpu_torch.parallel.dryrun"):
        assert new in MODULES


def test_root_exports_the_pruning_regime_without_jax_or_yaml():
    """``from sparsebit_tpu_torch import SparseModel, parse_sconfig`` (the
    pruning CLIs' import) in a process where jax, the JAX package and
    PyYAML are blocked; the zoo registers the new models."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'sparsebit_tpu', 'yaml'):\n"
            "    sys.modules[name] = None\n"
            "from sparsebit_tpu_torch import SparseModel, parse_sconfig\n"
            "from sparsebit_tpu_torch.models import MODEL_REGISTRY\n"
            "print(SparseModel.__name__, parse_sconfig.__name__, "
            "sorted(MODEL_REGISTRY))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("SparseModel parse_sconfig")
    for name in ("mobilenet_v2", "efficientnet_lite0", "regnetx_600mf",
                 "bert_qa", "bert_qa_tiny", "gpt2_small", "gpt2_tiny",
                 "yolov3_tiny", "yolov3", "yolov3_darknet21", "yolov4",
                 "yolov4_small", "yolov5s", "yolov5n", "bevdet_lite"):
        assert "'{}'".format(name) in out.stdout


CLIS = ["post_training_quantization/wikitext_gpt2/main_torch.py",
        "post_training_quantization/coco_yolov3_tiny/main_torch.py",
        "quantization_aware_training/nuscenes_bevdet/main_torch.py",
        "llm/tp_serve_demo_torch.py"]


@pytest.mark.parametrize("rel", CLIS)
def test_cli_imports_without_jax_or_yaml(rel):
    """Each of the model zoo's last three CLIs and the tensor-parallel
    demo loads (its imports, its argument parser) where jax, the JAX
    package and PyYAML are blocked, as on the card's machine."""
    path = ROOT / "examples" / rel
    code = ("import importlib.util, sys\n"
            "for name in ('jax', 'jaxlib', 'sparsebit_tpu', 'yaml'):\n"
            "    sys.modules[name] = None\n"
            "spec = importlib.util.spec_from_file_location('cli', {!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "print(callable(mod.main))\n").format(str(path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "True"
