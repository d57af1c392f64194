"""The graph regime's module system (port of ``sparsebit_tpu/nn``): the
module zoo (``modules``), the functional op-modules (``functional``) and
the ``torch.fx``-based tracer with the graph IR (``graph``)."""

from sparsebit_tpu_torch.nn.modules import (  # noqa: F401
    Module,
    Sequential,
    ModuleList,
    Conv2d,
    ConvTranspose2d,
    Linear,
    Embedding,
    BatchNorm2d,
    BatchNorm1d,
    LayerNorm,
    RMSNorm,
    ReLU,
    ReLU6,
    LeakyReLU,
    Sigmoid,
    SiLU,
    GELU,
    Mish,
    Hardsigmoid,
    Tanh,
    Softmax,
    MaxPool2d,
    AvgPool2d,
    AdaptiveAvgPool2d,
    Identity,
    Dropout,
    Flatten,
    Upsample,
    load_jax_state_dict,
    data_parallel,
)
from sparsebit_tpu_torch.nn.graph import (  # noqa: F401
    Graph,
    Node,
    SymbolicTensor,
    Tracer,
)
from sparsebit_tpu_torch.nn import functional  # noqa: F401
