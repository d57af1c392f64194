"""Graph-level PTQ/QAT regime of the port (port of
``sparsebit_tpu/quantization``): the config tree
(``quant_config.parse_qconfig``), the enums (``common``), the quantizer
descriptor, fake quantization with its straight-through gradients
(``fake_quant``), the observer and quantizer zoos, the QModule zoo
(``modules``), the graph passes (``converters``), layerwise calibration
(``tools``) and ``QuantModel``, which traces a model of
``sparsebit_tpu_torch.nn`` and runs the whole flow. Fake quantization is
elementwise PyTorch and convolutions and products are PyTorch calls: the
JAX package has no Pallas kernel on this regime either
(fake_quant.py:13-16)."""

from sparsebit_tpu_torch.quantization.quant_config import (  # noqa: F401
    parse_qconfig,
)


def __getattr__(name):
    # imported on first use: quant_model imports the module zoo, which
    # imports this package's submodules
    if name == "QuantModel":
        from sparsebit_tpu_torch.quantization.quant_model import QuantModel

        return QuantModel
    raise AttributeError(name)
