"""Quantized unary and identity ops (port of
``sparsebit_tpu/quantization/modules/unary.py``; reference:
sparsebit/quantization/modules/unary.py:9-92)."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr


@register_qmodule(sources=[nn.Identity])
class QIdentity(QuantOpr):
    """Also inserted on each input edge of a MultipleInputsQuantOpr node
    (quant_model.py:126-137)."""

    def __init__(self, org_module=None, config=None):
        super().__init__(org_module or nn.Identity(), config)


@register_qmodule(sources=[nn.Softmax])
class QSoftmax(QuantOpr):
    pass
