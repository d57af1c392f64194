"""Fuse passes (port of
``sparsebit_tpu/quantization/converters/fuse_operations.py``; reference:
sparsebit/quantization/converters/fuse_operations/).

- FuseBN folds a BatchNorm into the QConv2d / QLinear before it, along the
  port's weight axis 0 (OIHW, (out, in)); its quantized variant also
  rescales ``weight_quantizer.scale`` per channel (fuse_bn.py:36-124).
  Gated by SCHEDULE.FUSE_BN.
- DisableQuantChain: in a producer -> activation chain the follower's
  quantizers are disabled for good, since quantizing both the producer's
  output and the activation's input is redundant
  (disable_unnecessary_quant.py:116-147). Gated by
  SCHEDULE.DISABLE_UNNECESSARY_QUANT.
"""

import torch

from sparsebit_tpu_torch.quantization.converters.matcher import (
    MatchingNode,
    ReplacePatternBase,
)
from sparsebit_tpu_torch.quantization.modules.activations import (
    QGELU,
    QHardsigmoid,
    QLeakyReLU,
    QMish,
    QReLU,
    QReLU6,
    QSiLU,
    QSigmoid,
)
from sparsebit_tpu_torch.quantization.modules.conv import QConv2d
from sparsebit_tpu_torch.quantization.modules.linear import QLinear
from sparsebit_tpu_torch.quantization.modules.math import QAdd
from sparsebit_tpu_torch.quantization.modules.normalization import (
    QBatchNorm2d,
)


class FuseBN(ReplacePatternBase):
    def make_nodes(self):
        return [
            MatchingNode("cnn_layer", inputs=[None],
                         op_types=[QConv2d, QLinear]),
            MatchingNode("bn", inputs=["cnn_layer"],
                         op_types=[QBatchNorm2d]),
        ]

    def replace(self, graph, match):
        cnn_opr = match["cnn_layer"].op
        bn = match["bn"].op.module
        cnn = cnn_opr.module
        with torch.no_grad():
            rstd = 1.0 / torch.sqrt(bn.running_var + bn.eps)
            ratio = bn.weight * rstd  # a factor per out channel
            w = cnn.weight
            ratio_shape = [1] * w.dim()
            ratio_shape[cnn_opr.W_CH_AXIS] = -1  # 0: OIHW and (out, in)
            ratio_w = ratio.reshape(ratio_shape)
            cnn.weight.data = w * ratio_w
            bias = cnn.bias
            if bias is None:
                bias = torch.zeros_like(bn.running_mean)
            new_bias = (bias - bn.running_mean) * ratio + bn.bias
            if cnn.bias is None:
                cnn.bias = torch.nn.Parameter(new_bias)
            else:
                cnn.bias.data = new_bias
            wq = cnn_opr.weight_quantizer
            if wq is not None and wq.is_enable:
                # rescale the grid so that the fused weight keeps its
                # calibration (fuse_bn.py:94; abs keeps zero points valid)
                wq.scale = wq.scale * ratio_w.abs()
        graph.replace_all_uses(match["bn"], match["cnn_layer"].symbolic())
        return True


def _not_already_fused(node):
    op = node.op
    wq = getattr(op, "weight_quantizer", None)
    iq = getattr(op, "input_quantizer", None)
    return ((wq is not None and not wq.fake_fused)
            or (iq is not None and not iq.fake_fused))


class DisableQuantChain(ReplacePatternBase):
    STRICT_INTERNAL = False

    def __init__(self, producer_types, follower_types):
        self.producer_types = producer_types
        self.follower_types = follower_types

    def make_nodes(self):
        return [
            MatchingNode("producer", inputs=[None],
                         op_types=self.producer_types),
            MatchingNode("follower", inputs=["producer"],
                         op_types=self.follower_types,
                         checker=_not_already_fused),
        ]

    def replace(self, graph, match):
        op = match["follower"].op
        if op.weight_quantizer is not None:
            op.weight_quantizer.set_fake_fused()
        if op.input_quantizer is not None:
            op.input_quantizer.set_fake_fused()
        return True


_ACTS_AFTER_CONV = (QReLU, QReLU6, QSigmoid, QLeakyReLU, QMish, QSiLU,
                    QHardsigmoid)
_ACTS_AFTER_LINEAR = _ACTS_AFTER_CONV + (QGELU,)
_ACTS_AFTER_BN = _ACTS_AFTER_CONV
_ACTS_AFTER_ADD = (QReLU, QReLU6)


def fuse_operations(graph, schedule_cfg):
    """The fuse pipeline as the SCHEDULE config sets it
    (fuse_operations/lists.py)."""
    if schedule_cfg.FUSE_BN:
        FuseBN().apply(graph)
    if schedule_cfg.DISABLE_UNNECESSARY_QUANT:
        chains = [
            ((QConv2d,), (QBatchNorm2d,) + _ACTS_AFTER_CONV),
            ((QLinear,), (QBatchNorm2d,) + _ACTS_AFTER_LINEAR),
            ((QBatchNorm2d,), _ACTS_AFTER_BN),
            ((QAdd,), _ACTS_AFTER_ADD),
        ]
        for producers, followers in chains:
            DisableQuantChain(producers, followers).apply(graph)
    return graph
