"""QModule registry (port of ``sparsebit_tpu/quantization/modules``;
reference: sparsebit/quantization/modules/__init__.py:4-53).
``QMODULE_MAP`` maps the port's float op-module classes
(``sparsebit_tpu_torch.nn``) to their quantized wrappers;
``register_qmodule(sources=[...])`` fills it."""

QMODULE_MAP = {}


def register_qmodule(sources):
    def wrapper(qmodule_cls):
        for src in sources:
            QMODULE_MAP[src] = qmodule_cls
        qmodule_cls.SOURCES = sources
        return qmodule_cls

    return wrapper


from sparsebit_tpu_torch.quantization.modules.base import (  # noqa: E402,F401
    MultipleInputsQuantOpr,
    QuantOpr,
)
from sparsebit_tpu_torch.quantization.modules import (  # noqa: E402,F401
    activations,
    conv,
    embedding,
    linear,
    math as math_ops,
    matmul,
    normalization,
    pool,
    resize,
    shape as shape_ops,
    unary,
)
from sparsebit_tpu_torch.nn import functional as _F  # noqa: E402
from sparsebit_tpu_torch.nn import modules as _nn  # noqa: E402

# float modules that pass through conversion untouched
PASSTHROUGH_MODULES = (
    _nn.MaxPool2d,
    _nn.Dropout,
    _nn.Flatten,
    _F.Reshape,
    _F.Transpose,
    _F.Permute,
    _F.Split,
    _F.Expand,
    _F.GetItem,
    _F.Concat,
    _F.Detach,
    _F.Cast,
    _F.Where,
)
