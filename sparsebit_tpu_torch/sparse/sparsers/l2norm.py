"""L2-norm sparser (port of ``sparsebit_tpu/sparse/sparsers/l2norm.py``,
the JAX package's extension; the interface of l1norm)."""

from sparsebit_tpu_torch.sparse.sparsers import register_sparser
from sparsebit_tpu_torch.sparse.sparsers.base import Sparser
from sparsebit_tpu_torch.sparse.sparsers.l1norm import _other_axes


@register_sparser
class L2NormSparser(Sparser):
    TYPE = "l2norm"

    def element_scores(self, weight):
        return weight.square()

    def channel_scores(self, weight, ch_axis):
        return weight.square().sum(dim=_other_axes(weight, ch_axis)).sqrt()
