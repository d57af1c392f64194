"""Quantizer registry (port of
``sparsebit_tpu/quantization/quantizers/__init__.py``; reference:
sparsebit/quantization/quantizers/__init__.py:4-28).

uniform, lsq, lsq+, pact, dorefa and adaround (with its layer
reconstruction, ``adaround.reconstruct_qlayer``).
"""

QUANTIZERS_MAP = {}


def register_quantizer(quantizer_cls):
    QUANTIZERS_MAP[quantizer_cls.TYPE.lower()] = quantizer_cls
    return quantizer_cls


from sparsebit_tpu_torch.quantization.quantizers.base import (  # noqa: E402,F401
    Quantizer,
)
from sparsebit_tpu_torch.quantization.quantizers import (  # noqa: E402,F401
    adaround,
    dorefa,
    lsq,
    lsq_plus,
    pact,
    uniform,
)


def build_quantizer(cfg):
    quantizer_type = cfg.QUANTIZER.TYPE.lower()
    assert quantizer_type in QUANTIZERS_MAP, "no quantizer named {}".format(
        quantizer_type)
    return QUANTIZERS_MAP[quantizer_type](cfg)
