"""PyTorch/CUDA port of ``sparsebit_tpu`` for NVIDIA Hopper (sm_90a).

The package mirrors the JAX package's tree (``ops/`` kernels and their
plain versions, ``llm/`` model, cache, decode and serving code) and imports
neither JAX nor ``sparsebit_tpu``. Every TPU (Pallas) kernel it ports is a
CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at first use into
``csrc/build/`` and bound through ``ctypes`` (``ops/_kernels.py``). Each
kernel wrapper runs its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other.
"""

import torch


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
