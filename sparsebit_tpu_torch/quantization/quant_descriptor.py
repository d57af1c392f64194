"""QuantDescriptor: bit width, range, scheme and axes of one quantizer
(port of ``sparsebit_tpu/quantization/quant_descriptor.py``; reference:
sparsebit/quantization/quantizers/quant_descriptor.py:5-111).

ch_axis follows A.OBSERVER.LAYOUT for features (NCHW -> 1, NLC -> 2,
NHWC -> 3) and is 0 (out-channel first) for weights; bs_axis is 0 for
features and None for weights.
"""

from sparsebit_tpu_torch.quantization.common import (
    Granularity,
    QuantTarget,
    get_qscheme,
    make_qscheme,
)

_FEATURE_CH_AXIS = {"NCHW": 1, "NLC": 2, "NHWC": 3}


class QuantDescriptor:
    def __init__(self, cfg):
        self._cfg = cfg
        target = cfg.TARGET
        self._target = target[0] if isinstance(target, (list, tuple)) \
            else target
        self._scheme = get_qscheme(cfg.QSCHEME)
        self._bit = cfg.QUANTIZER.BIT
        self._qmin, self._qmax, self._type = self.calc_qmin_qmax(
            self._bit, self._scheme)
        self._ch_axis = self._set_channel_axis()
        self._bs_axis = self._set_batchsize_axis()
        self.is_perchannel = self._scheme.is_perchannel
        self.is_symmetric = self._scheme.is_symmetric
        # -1 disables group-wise quant; only the LLM (GPTQ) path sets it
        self.groupsize = int(getattr(cfg.QUANTIZER, "GROUPSIZE", -1))

    @staticmethod
    def calc_qmin_qmax(bit, scheme):
        if scheme.is_symmetric:
            return -(2 ** (bit - 1)), 2 ** (bit - 1) - 1, "int{}".format(bit)
        return 0, 2 ** bit - 1, "uint{}".format(bit)

    def _layout(self):
        layout = self._cfg.OBSERVER.LAYOUT
        if layout not in _FEATURE_CH_AXIS:
            raise NotImplementedError("unsupported layout {}".format(layout))
        return layout

    def _set_channel_axis(self):
        if self._target == QuantTarget.FEATURE:
            return _FEATURE_CH_AXIS[self._layout()]
        return 0  # weight: out-channel first

    def _set_batchsize_axis(self):
        if self._target == QuantTarget.FEATURE:
            self._layout()
            return 0
        return None

    def set_bit(self, bit):
        self._bit = bit
        self._qmin, self._qmax, self._type = self.calc_qmin_qmax(
            bit, self._scheme)

    def set_symmetric(self, is_symmetric):
        self.is_symmetric = bool(is_symmetric)
        self._scheme = make_qscheme(self.is_perchannel, self.is_symmetric)
        self._qmin, self._qmax, self._type = self.calc_qmin_qmax(
            self._bit, self._scheme)

    @property
    def granularity(self):
        return (Granularity.CHANNELWISE if self.is_perchannel
                else Granularity.LAYERWISE)

    @property
    def target(self):
        return self._target

    @property
    def scheme(self):
        return self._scheme

    @property
    def bit(self):
        return self._bit

    @property
    def qmin(self):
        return self._qmin

    @property
    def qmax(self):
        return self._qmax

    @property
    def qrange(self):
        return (self._qmin, self._qmax)

    @property
    def ch_axis(self):
        return self._ch_axis

    @property
    def bs_axis(self):
        return self._bs_axis

    def __repr__(self):
        return "{}\t qmin: {}  qmax: {}, qscheme: {}".format(
            self._type, self.qmin, self.qmax, self.scheme)
