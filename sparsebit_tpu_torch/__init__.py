"""PyTorch/CUDA port of ``sparsebit_tpu`` for NVIDIA Hopper (sm_90a).

The package mirrors the JAX package's tree (``ops/`` kernels and their
plain versions; ``llm/`` model, cache, decode and serving code;
``quantization/``, the graph-level PTQ regime with its QModules,
converters, observers, quantizers and calibration; ``sparse/``, the
pruning regime with its sparsers and SModules; ``nn/``, the module
zoo and the ``torch.fx`` tracer; ``models/``, the model zoo and the
checkpoint importers; ``utils/``, the config tree and the profiling
helpers; ``parallel/``, the mesh, process-group setup and tensor-parallel
serving on ``torch.distributed``) and imports neither JAX nor
``sparsebit_tpu``. Every
TPU (Pallas) kernel it ports is a CUDA C++ kernel under ``csrc/``, built
with ``nvcc`` at first use into ``csrc/build/`` and bound through
``ctypes`` (``ops/_kernels.py``). Each kernel wrapper runs its plain
PyTorch version for CPU tensors and launches the kernel for CUDA
tensors; it never falls back from one to the other. The graph regime has
no Pallas kernel in the JAX package, so it has no kernel here either.
"""

import subprocess

import torch


def device_line(device):
    """The card's name and power limit as nvidia-smi reports them (the
    line a measurement is recorded with), or the device type off the
    card."""
    if torch.device(device).type != "cuda":
        return torch.device(device).type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Raises when CUDA is absent and no device was named,
    so a missing card never turns into a quiet CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device {} requested but CUDA is absent".format(
            device))
    return device


def __getattr__(name):
    # QuantModel, parse_qconfig, SparseModel and parse_sconfig as the JAX
    # package exports them, imported on first use (the graph regime
    # imports torch.fx)
    if name in ("QuantModel", "parse_qconfig"):
        from sparsebit_tpu_torch import quantization

        return getattr(quantization, name)
    if name in ("SparseModel", "parse_sconfig"):
        from sparsebit_tpu_torch import sparse

        return getattr(sparse, name)
    raise AttributeError(name)
