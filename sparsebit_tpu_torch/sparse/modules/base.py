"""SparseOpr base: wraps a float op-module with pruning masks (port of
``sparsebit_tpu/sparse/modules/base.py``; reference:
sparsebit/sparse/modules/conv.py:8-44).

The masks ``w_mask`` and ``b_mask`` (None where the module has no bias)
are registered buffers on the weight's device, so that no optimizer over
the model's parameters sees them: a masked finetune leaves them {0, 1}
with nothing frozen by hand (the JAX package carries them in the params
pytree and zeroes their gradients). ``execute`` multiplies the wrapped
module's weight and bias by them and hands the products down as the
module's ``params`` replacement; a mask in ``params`` overrides the
buffer, as in the JAX package. The wrapped module's parameters stay the
source of truth, so a pruned weight keeps its stored value and takes no
gradient through the product.
"""

import torch

from sparsebit_tpu_torch.nn.modules import Module
from sparsebit_tpu_torch.sparse.sparsers import build_sparser

MASKS = ("w_mask", "b_mask", "ch_mask")


class SparseOpr(Module):
    HAS_WEIGHT = False
    W_CH_AXIS = 0  # out-channel axis of the wrapped module's weight

    def __init__(self, org_module, config=None):
        super().__init__()
        self.module = org_module
        self.sparser = None
        self._sparse_config = config
        if self.HAS_WEIGHT:
            self.register_buffer("w_mask", torch.ones_like(
                org_module.weight, requires_grad=False))
            b = org_module.bias
            self.register_buffer("b_mask", torch.ones_like(
                b, requires_grad=False) if b is not None else None)

    def build_sparser(self, config):
        if self.HAS_WEIGHT:
            self.sparser = build_sparser(config)

    def set_ratio(self, ratio):
        if self.sparser is not None:
            self.sparser.ratio = float(ratio)

    def calc_mask(self):
        """Compute and store the masks; returns the channel mask
        (structured) or None (unstructured)."""
        if self.sparser is None:
            return None
        w_mask, ch_mask = self.sparser.calc_mask(self.module.weight,
                                                 self.W_CH_AXIS)
        self.w_mask = w_mask
        if ch_mask is not None and self.b_mask is not None:
            self.b_mask = ch_mask
        return ch_mask

    # ---- state: the wrapped module's and the masks ----------------------
    def leaf_state_dict(self):
        out = dict(self.module.leaf_state_dict())
        out.update(super().leaf_state_dict())
        return out

    def load_leaf_state_dict(self, sd):
        rest = {k: v for k, v in sd.items() if k not in MASKS}
        if rest:
            self.module.load_leaf_state_dict(rest)
        super().load_leaf_state_dict(
            {k: v for k, v in sd.items() if k in MASKS})

    def _masked_params(self, params):
        params = dict(params or {})
        w_mask = params.pop("w_mask", self.w_mask)
        b_mask = params.pop("b_mask", self.b_mask)
        params["weight"] = self.module.get(params, "weight") * w_mask
        if b_mask is not None and self.module.bias is not None:
            params["bias"] = self.module.get(params, "bias") * b_mask
        return params

    def execute(self, x, *args, params=None, training=False, **kwargs):
        if self.HAS_WEIGHT:
            params = self._masked_params(params)
        return self.module.execute(x, *args, params=params,
                                   training=training, **kwargs)
