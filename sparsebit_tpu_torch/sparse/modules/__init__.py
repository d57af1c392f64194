"""SModule registry (port of ``sparsebit_tpu/sparse/modules``; reference:
sparsebit/sparse/modules/__init__.py). ``SMODULE_MAP`` maps the port's
float op-module classes (``sparsebit_tpu_torch.nn``) to their sparse
wrappers; ``register_smodule(sources=[...])`` fills it."""

SMODULE_MAP = {}


def register_smodule(sources):
    def wrapper(cls):
        for src in sources:
            SMODULE_MAP[src] = cls
        return cls

    return wrapper


from sparsebit_tpu_torch.sparse.modules.base import (  # noqa: E402,F401
    SparseOpr,
)
from sparsebit_tpu_torch.sparse.modules import (  # noqa: E402,F401
    conv,
    linear,
    normalization,
)
