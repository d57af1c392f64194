"""Sparse BatchNorm (port of
``sparsebit_tpu/sparse/modules/normalization.py``; reference:
sparsebit/sparse/modules/normalization.py:8-28): it receives the channel
mask of its producer conv or linear and multiplies its output's last
(channel) axis by it (activations are NHWC / NLC), so a pruned channel
is an exact zero in the feature map."""

import torch

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.sparse.modules import register_smodule
from sparsebit_tpu_torch.sparse.modules.base import SparseOpr


@register_smodule(sources=[nn.BatchNorm2d, nn.BatchNorm1d])
class SBatchNorm2d(SparseOpr):
    HAS_WEIGHT = False

    def __init__(self, org_module, config=None):
        super().__init__(org_module, config)
        self.register_buffer("ch_mask", torch.ones(
            org_module.num_features, device=org_module.weight.device))

    def set_channel_mask(self, ch_mask):
        self.ch_mask = ch_mask.detach().to(torch.float32)

    def execute(self, x, *args, params=None, training=False, **kwargs):
        params = dict(params or {})
        ch_mask = params.pop("ch_mask", self.ch_mask)
        out = self.module.execute(x, *args, params=params or None,
                                  training=training, **kwargs)
        return out * ch_mask
