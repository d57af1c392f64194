"""QuantOpr base classes (port of
``sparsebit_tpu/quantization/modules/base.py``; reference:
sparsebit/quantization/modules/base.py:9-109).

A QuantOpr wraps a float op-module and owns an ``input_quantizer`` (from
the A config) and, where the op has a weight, a ``weight_quantizer``
(from the W config). The wrapped module's parameters stay the source of
truth; ``execute`` fake-quantizes the weight and hands it down as the
module's ``params`` replacement.

``params`` at execute time is a flat dict that may hold the wrapped
module's state ("weight", "bias", ...) and quantizer state, prefixed:
"input_quantizer.scale", "weight_quantizer.v", ...
"""

import torch

from sparsebit_tpu_torch.nn.modules import Module
from sparsebit_tpu_torch.quantization.common import QuantTarget
from sparsebit_tpu_torch.quantization.quantizers import build_quantizer


def _split_params(params):
    if not params:
        return None, None, None
    mparams, iqp, wqp = {}, {}, {}
    for k, v in params.items():
        if k.startswith("input_quantizer."):
            iqp[k[len("input_quantizer."):]] = v
        elif k.startswith("weight_quantizer."):
            wqp[k[len("weight_quantizer."):]] = v
        else:
            mparams[k] = v
    return mparams or None, iqp or None, wqp or None


def _quantizer_config(src, target):
    cfg = src.clone()
    cfg.defrost()
    cfg.TARGET = [target]
    cfg.freeze()
    return cfg


class QuantOpr(Module):
    """Single-input quantized op wrapper."""

    WEIGHT_QUANT = False  # a subclass sets True where the op has a weight
    W_CH_AXIS = 0  # out-channel axis of the wrapped module's weight
    INPUT_QUANT = True

    def __init__(self, org_module, config=None):
        super().__init__()
        self.module = org_module
        self.input_quantizer = None
        self.weight_quantizer = None
        self._quant_config = config

    # ---- quantizer construction (reference base.py:36-54) ----------------
    def build_quantizer(self, config):
        if self.INPUT_QUANT:
            self.input_quantizer = build_quantizer(
                _quantizer_config(config.A, QuantTarget.FEATURE))
        if self.WEIGHT_QUANT:
            self.weight_quantizer = build_quantizer(
                _quantizer_config(config.W, QuantTarget.WEIGHT))
            self.weight_quantizer.set_ch_axis(self.W_CH_AXIS)

    def set_quant(self, w_quant=False, a_quant=False):
        if self.weight_quantizer is not None:
            (self.weight_quantizer.enable_quant() if w_quant
             else self.weight_quantizer.disable_quant())
        if self.input_quantizer is not None:
            (self.input_quantizer.enable_quant() if a_quant
             else self.input_quantizer.disable_quant())

    def train(self, mode=True):
        super().train(mode)
        for q in (self.input_quantizer, self.weight_quantizer):
            if q is not None:
                q.train(mode)
        return self

    def _quantizers(self):
        return (("input_quantizer", self.input_quantizer),
                ("weight_quantizer", self.weight_quantizer))

    # ---- state ------------------------------------------------------------
    def leaf_state_dict(self):
        out = dict(self.module.leaf_state_dict())
        for prefix, q in self._quantizers():
            if q is not None and q.is_enable:
                out["{}.scale".format(prefix)] = q.scale
                out["{}.zero_point".format(prefix)] = q.zero_point
                for k, v in q.trainable_params().items():
                    if k not in ("scale", "zero_point") and v is not None:
                        out["{}.{}".format(prefix, k)] = v
        return out

    def load_leaf_state_dict(self, sd):
        mparams, iqp, wqp = _split_params(sd)
        if mparams:
            self.module.load_leaf_state_dict(mparams)
        for q, p in ((self.input_quantizer, iqp),
                     (self.weight_quantizer, wqp)):
            if q is not None and p:
                for k, v in p.items():
                    setattr(q, k, torch.as_tensor(v))

    def trainable_params(self):
        """QAT learnables: the wrapped module's state and the enabled
        quantizers' learnables."""
        out = dict(self.module.leaf_state_dict())
        for prefix, q in self._quantizers():
            if q is not None and q.is_enable:
                for k, v in q.trainable_params().items():
                    out["{}.{}".format(prefix, k)] = v
        return out

    def get_weight(self):
        return self.module._parameters.get("weight")

    # ---- execution --------------------------------------------------------
    def execute(self, x, *args, params=None, training=False, **kwargs):
        mparams, iqp, wqp = _split_params(params)
        if self.input_quantizer is not None:
            x = self.input_quantizer(x, iqp)
        wq = self.weight_quantizer
        if wq is not None and wq.is_enable:
            mparams = dict(mparams or {})
            mparams["weight"] = wq(self.module.get(mparams, "weight"), wqp)
        return self.module.execute(x, *args, params=mparams,
                                   training=training, **kwargs)

    def extra_repr(self):
        parts = []
        if self.input_quantizer is not None and self.input_quantizer.is_enable:
            parts.append("a{}bit".format(self.input_quantizer.bit))
        if (self.weight_quantizer is not None
                and self.weight_quantizer.is_enable):
            parts.append("w{}bit".format(self.weight_quantizer.bit))
        return " ".join(parts)


class MultipleInputsQuantOpr(QuantOpr):
    """Multi-input op (Add, Concat, MatMul, ...): no input quantizer of its
    own; QuantModel inserts a QIdentity on each input edge instead
    (reference base.py:76-109, quant_model.py:126-137)."""

    INPUT_QUANT = False

    def build_quantizer(self, config):
        pass

    def execute(self, *args, params=None, training=False, **kwargs):
        mparams, _, _ = _split_params(params)
        return self.module.execute(*args, params=mparams, training=training,
                                   **kwargs)
