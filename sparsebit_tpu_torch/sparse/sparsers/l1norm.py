"""L1-norm sparser (port of ``sparsebit_tpu/sparse/sparsers/l1norm.py``;
reference: sparsebit/sparse/sparsers/l1norm.py:8-43).

unstructure: |w| thresholded at the RATIO quantile.
structure: channels ranked by their L1 norm; the lowest RATIO fraction
pruned.
"""

from sparsebit_tpu_torch.sparse.sparsers import register_sparser
from sparsebit_tpu_torch.sparse.sparsers.base import Sparser


def _other_axes(weight, ch_axis):
    return tuple(i for i in range(weight.dim()) if i != ch_axis)


@register_sparser
class L1NormSparser(Sparser):
    TYPE = "l1norm"

    def element_scores(self, weight):
        return weight.abs()

    def channel_scores(self, weight, ch_axis):
        return weight.abs().sum(dim=_other_axes(weight, ch_axis))
