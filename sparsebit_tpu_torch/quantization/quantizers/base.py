"""Quantizer base class (port of
``sparsebit_tpu/quantization/quantizers/base.py``; reference:
sparsebit/quantization/quantizers/base.py:10-143).

State (scale, zero_point and any QAT learnable) is held as tensors. A
learnable one is a leaf that requires a gradient, so a ``torch.optim``
optimiser can train what ``trainable_params`` returns; as in the JAX
package, ``__call__(x, params=...)`` also takes replacements for them.
"""

import torch

from sparsebit_tpu_torch.quantization.common import Backend, QuantTarget
from sparsebit_tpu_torch.quantization.fake_quant import fake_quant
from sparsebit_tpu_torch.quantization.observers import build_observer
from sparsebit_tpu_torch.quantization.quant_descriptor import QuantDescriptor


def learnable(t):
    """A float32 leaf copy of t that requires a gradient."""
    return torch.as_tensor(t, dtype=torch.float32).detach().clone(
    ).requires_grad_(True)


class Quantizer:
    TYPE = "base"
    dp_group = None  # set by nn.data_parallel

    def __init__(self, config):
        self.cfg = config
        self.qdesc = QuantDescriptor(config)
        self.observer = build_observer(config, self.qdesc)
        self.backend = Backend.VIRTUAL
        self.is_enable = False
        self.fake_fused = False  # permanently disabled (base.py:74-80)
        self.training = False
        self.dims = None  # rank of the observed tensor, for qparam broadcast
        self.scale = torch.ones(())
        self.zero_point = torch.zeros(())

    # ---- calibration ------------------------------------------------------
    def update_observer(self, x):
        self.dims = x.dim()
        self.observer.update(x.detach())

    def calc_qparams(self):
        if self.fake_fused:
            return self.scale, self.zero_point
        scale, zero_point = self.observer.calc_qparams()
        self.scale = self._broadcast_qparams(scale)
        self.zero_point = self._broadcast_qparams(zero_point)
        return self.scale, self.zero_point

    def _broadcast_qparams(self, params):
        """Per-channel qparams reshaped to the observed rank with C on
        ch_axis (base.py:97-109); per-tensor ones to 0-d."""
        params = torch.as_tensor(params, dtype=torch.float32)
        if not self.qdesc.is_perchannel or params.dim() == 0:
            return params.reshape(())
        assert self.dims is not None, (
            "call update_observer before calc_qparams")
        shape = [1] * self.dims
        ch_axis = self.qdesc.ch_axis
        if ch_axis >= self.dims:
            ch_axis = self.dims - 1  # channels-last on lower-rank data
        shape[ch_axis] = -1
        return params.reshape(shape)

    # ---- state toggles ----------------------------------------------------
    def set_fake_fused(self):
        self.fake_fused = True
        self.is_enable = False

    def enable_quant(self):
        if not self.fake_fused:
            self.is_enable = True

    def disable_quant(self):
        self.is_enable = False

    def set_bit(self, bit):
        self.qdesc.set_bit(bit)

    def set_backend(self, backend):
        self.backend = backend

    def set_ch_axis(self, axis):
        """Override the weight out-channel axis for this op's weight
        layout; the descriptor's default is 0."""
        self.qdesc._ch_axis = axis

    def train(self, mode=True):
        self.training = mode

    # ---- QAT learnables ---------------------------------------------------
    def trainable_params(self):
        """{name: learnable tensor} (empty for PTQ quantizers)."""
        return {}

    def load_trainable_params(self, params):
        for k, v in params.items():
            setattr(self, k, learnable(v))

    # ---- forward ----------------------------------------------------------
    def _qparams_preprocess(self, x, params):
        scale = params.get("scale", self.scale) if params else self.scale
        zp = (params.get("zero_point", self.zero_point) if params
              else self.zero_point)
        return scale, zp

    def _forward(self, x, scale, zero_point, params=None):
        return fake_quant(x, scale, zero_point, self.qdesc.qmin,
                          self.qdesc.qmax)

    def _grad_elements(self, x):
        """The elements LSQ's gradient scale counts: a channel's or the
        tensor's, of the whole global batch for a feature under data
        parallelism (``dp_group``, set by ``nn.data_parallel``), as the
        JAX package counts them under jit over a batch sharded on "dp"."""
        n = x.numel() / x.shape[self.qdesc.ch_axis] if self.is_perchannel \
            else x.numel()
        if self.qdesc.target == QuantTarget.FEATURE and \
                self.dp_group is not None:
            n *= torch.distributed.get_world_size(self.dp_group)
        return n

    def __call__(self, x, params=None):
        if self.is_enable and not self.fake_fused:
            scale, zero_point = self._qparams_preprocess(x, params)
            return self._forward(x, scale, zero_point, params=params)
        return x

    @property
    def is_perchannel(self):
        return self.qdesc.is_perchannel

    @property
    def is_symmetric(self):
        return self.qdesc.is_symmetric

    @property
    def bit(self):
        return self.qdesc.bit

    def __repr__(self):
        return "{}(bit={}, enable={}, qdesc={})".format(
            type(self).__name__, self.bit, self.is_enable, self.qdesc)
