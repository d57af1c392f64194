"""Common enums and qscheme helpers (port of
``sparsebit_tpu/quantization/common.py``; reference:
sparsebit/quantization/common.py:5-51). A ``QScheme`` carries
(perchannel, symmetric) explicitly instead of torch's qscheme enums, so
that one config means the same thing to both packages."""

from enum import Enum

import torch


class Granularity(Enum):
    LAYERWISE = 0
    CHANNELWISE = 1
    GROUPWISE = 2  # groupsize quant (GPTQ) in the same core


class QuantTarget(Enum):
    WEIGHT = 0
    FEATURE = 1


class Backend(Enum):
    VIRTUAL = 0
    ONNXRUNTIME = 1
    TENSORRT = 2
    TPU = 3  # the JAX package's native backend; its deploy path is not
    # ported yet, the value is kept so that configs parse alike


class QScheme(Enum):
    PER_TENSOR_SYMMETRIC = 0
    PER_TENSOR_AFFINE = 1
    PER_CHANNEL_SYMMETRIC = 2
    PER_CHANNEL_AFFINE = 3

    @property
    def is_perchannel(self):
        return self in (QScheme.PER_CHANNEL_SYMMETRIC,
                        QScheme.PER_CHANNEL_AFFINE)

    @property
    def is_symmetric(self):
        return self in (QScheme.PER_TENSOR_SYMMETRIC,
                        QScheme.PER_CHANNEL_SYMMETRIC)


_BACKENDS = {
    "virtual": Backend.VIRTUAL,
    "onnxruntime": Backend.ONNXRUNTIME,
    "tensorrt": Backend.TENSORRT,
    "tpu": Backend.TPU,
}

_QSCHEMES = {
    "per-tensor-symmetric": QScheme.PER_TENSOR_SYMMETRIC,
    "per-tensor-affine": QScheme.PER_TENSOR_AFFINE,
    "per-channel-symmetric": QScheme.PER_CHANNEL_SYMMETRIC,
    "per-channel-affine": QScheme.PER_CHANNEL_AFFINE,
}


def get_backend(backend):
    if backend not in _BACKENDS:
        raise TypeError("only support backend in {}, not {}".format(
            list(_BACKENDS), backend))
    return _BACKENDS[backend]


def get_qscheme(qscheme):
    if qscheme not in _QSCHEMES:
        raise TypeError(
            "only support a qscheme equals to per-[tensor/channel]-"
            "[affine/symmetric], not {}".format(qscheme))
    return _QSCHEMES[qscheme]


def make_qscheme(perchannel, symmetric):
    return {
        (True, True): QScheme.PER_CHANNEL_SYMMETRIC,
        (True, False): QScheme.PER_CHANNEL_AFFINE,
        (False, True): QScheme.PER_TENSOR_SYMMETRIC,
        (False, False): QScheme.PER_TENSOR_AFFINE,
    }[(perchannel, symmetric)]


def div_exact(v, c):
    """v / c for a plain number c, correctly rounded on every device.
    PyTorch's CUDA kernel divides by a Python scalar as a multiply by its
    reciprocal (a bit less exact, so the card's qparams would differ from
    the CPU's); the JAX package's eager callers divide. (Its jitted ones
    multiply: XLA rewrites a divide by a constant, which the MSE search
    follows.)"""
    return v / torch.tensor(c, dtype=v.dtype, device=v.device)
