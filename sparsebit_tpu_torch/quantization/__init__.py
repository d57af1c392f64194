"""Graph-level PTQ/QAT regime of the port (port of
``sparsebit_tpu/quantization``), bottom layer first: the config tree
(``quant_config.parse_qconfig``), the enums (``common``), the quantizer
descriptor (``quant_descriptor``), fake quantization with its straight-
through gradients (``fake_quant``), and the observer and quantizer zoos
(``observers``, ``quantizers``). The graph tracer, the QModules,
``QuantModel`` and calibration build on this layer and are not ported
yet. Fake quantization is elementwise PyTorch: the JAX package has no
Pallas kernel for it either (fake_quant.py:13-16)."""

from sparsebit_tpu_torch.quantization.quant_config import (  # noqa: F401
    parse_qconfig,
)
