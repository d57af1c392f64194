"""Quantized embedding: weight-only, the integer input is never quantized
(port of ``sparsebit_tpu/quantization/modules/embedding.py``; reference:
sparsebit/quantization/modules/embedding.py:8)."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr


@register_qmodule(sources=[nn.Embedding])
class QEmbedding(QuantOpr):
    WEIGHT_QUANT = True
    W_CH_AXIS = 0  # (num_embeddings, dim): a channel is a row

    def build_quantizer(self, config):
        super().build_quantizer(config)
        if self.input_quantizer is not None:
            self.input_quantizer.set_fake_fused()
