"""Network-slimming sparser (Liu et al., ICCV'17; port of
``sparsebit_tpu/sparse/sparsers/slimming.py``): structured channel
pruning ranked by the following BatchNorm's |gamma|.

SparseModel hands the successor BatchNorm's gamma to ``set_bn_weight``
before ``calc_mask``; without a BatchNorm the criterion falls back to the
weight's L1 norm.
"""

from sparsebit_tpu_torch.sparse.sparsers import register_sparser
from sparsebit_tpu_torch.sparse.sparsers.base import Sparser
from sparsebit_tpu_torch.sparse.sparsers.l1norm import _other_axes


@register_sparser
class SlimmingSparser(Sparser):
    TYPE = "slimming"

    def __init__(self, config):
        super().__init__(config)
        self.bn_weight = None

    def set_bn_weight(self, gamma):
        self.bn_weight = gamma

    def element_scores(self, weight):
        return weight.abs()

    def channel_scores(self, weight, ch_axis):
        if self.bn_weight is not None:
            return self.bn_weight.detach().abs()
        return weight.abs().sum(dim=_other_axes(weight, ch_axis))
