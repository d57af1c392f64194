"""Quantizer registry (port of
``sparsebit_tpu/quantization/quantizers/__init__.py``; reference:
sparsebit/quantization/quantizers/__init__.py:4-28).

Ported: uniform, lsq, lsq+, pact and dorefa. adaround comes with the
calibration tools' layer reconstruction; until then ``build_quantizer``
raises NotImplementedError for it.
"""

QUANTIZERS_MAP = {}
NOT_PORTED = ("adaround",)


def register_quantizer(quantizer_cls):
    QUANTIZERS_MAP[quantizer_cls.TYPE.lower()] = quantizer_cls
    return quantizer_cls


from sparsebit_tpu_torch.quantization.quantizers.base import (  # noqa: E402,F401
    Quantizer,
)
from sparsebit_tpu_torch.quantization.quantizers import (  # noqa: E402,F401
    dorefa,
    lsq,
    lsq_plus,
    pact,
    uniform,
)


def build_quantizer(cfg):
    quantizer_type = cfg.QUANTIZER.TYPE.lower()
    if quantizer_type in NOT_PORTED:
        raise NotImplementedError(
            "quantizer {!r} is not ported yet (it comes with the "
            "calibration tools' layer reconstruction)".format(quantizer_type))
    assert quantizer_type in QUANTIZERS_MAP, "no quantizer named {}".format(
        quantizer_type)
    return QUANTIZERS_MAP[quantizer_type](cfg)
