"""Quantized normalization ops (port of
``sparsebit_tpu/quantization/modules/normalization.py``): BatchNorm is
wrapped but not quantized (it is there to be fused into the conv before
it); LayerNorm and RMSNorm are input-quantized only."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr


@register_qmodule(sources=[nn.BatchNorm2d, nn.BatchNorm1d])
class QBatchNorm2d(QuantOpr):
    INPUT_QUANT = False
    WEIGHT_QUANT = False


@register_qmodule(sources=[nn.LayerNorm, nn.RMSNorm])
class QLayerNorm(QuantOpr):
    INPUT_QUANT = True
    WEIGHT_QUANT = False
