"""Packed linear containers (port of ``sparsebit_tpu/llm/quant.py``:
``DenseLinear`` and ``QuantLinear``).

Weight convention as in the JAX package: (in_features K, out_features N),
``x @ w``; group scales/zeros (G, N) along K. ``QuantLinear.__call__`` is
the W4A8 path (the JAX ``impl="a8"``), the only one the serving engine
uses. ``LLMQuantizer`` and ``from_dense`` come with the GPTQ port.
"""

import torch

from sparsebit_tpu_torch.ops import matvec as _mv
from sparsebit_tpu_torch.ops.packing import (
    pack_columns,
    pack_s4_rows,
    pallas_n_pad,
    unpack_columns,
)
from sparsebit_tpu_torch.ops.quant_matmul import (
    dequant_weights,
    quant_matmul_a8,
    quant_matmul_a8_stacked,
)


class DenseLinear:
    """Plain dense linear; 2-D inputs of at most 8 rows go to the bf16
    matvec kernel K9 (as quant.py:103-113), everything else to
    ``torch.matmul``."""

    def __init__(self, w, bias=None):
        self.w = w
        self.bias = bias

    @property
    def in_features(self):
        return self.w.shape[0]

    @property
    def out_features(self):
        return self.w.shape[1]

    def __call__(self, x):
        if _mv.use_matvec(x, self.w, self.bias):
            return _mv.matvec(x, self.w)
        out = torch.matmul(x, self.w.to(x.dtype))
        if self.bias is not None:
            out = out + self.bias
        return out


class QuantLinear:
    """Packed low-bit linear: ``packed`` is a dict of uint8 containers
    (the fold layout ``"w"``/``"low2"``/``"high1"`` of pack_columns, or the
    ``"s4r"`` signed row-pair serving layout); scales/zeros (G, N). Leaves
    may carry a leading layer axis (decode.stack_layers), read through
    ``call_stacked``."""

    def __init__(self, packed, scales, zeros, bits, groupsize, out_features,
                 bias=None, perm=None):
        self.packed = packed
        self.scales = scales
        self.zeros = zeros
        self.bits = bits
        self.groupsize = groupsize
        self.out_features = out_features
        self.bias = bias
        self.perm = perm  # act-order input permutation (K,), or None

    def _replace(self, **kw):
        fields = dict(packed=self.packed, scales=self.scales,
                      zeros=self.zeros, bits=self.bits,
                      groupsize=self.groupsize,
                      out_features=self.out_features, bias=self.bias,
                      perm=self.perm)
        fields.update(kw)
        return QuantLinear(**fields)

    @classmethod
    def from_codes(cls, codes, scales, zeros, bits, groupsize, bias=None,
                   perm=None):
        """Pack integer codes (K, N); N is padded to the JAX package's
        packed-width multiple with columns that dequantize to exactly 0."""
        N = codes.shape[1]
        pad = pallas_n_pad(N, bits)
        if pad:
            codes = torch.nn.functional.pad(codes, (0, pad))
            scales = torch.nn.functional.pad(scales, (0, pad), value=1.0)
            zeros = torch.nn.functional.pad(zeros, (0, pad))
        return cls(pack_columns(codes, bits), scales, zeros, bits, groupsize,
                   N, bias, perm)

    @property
    def in_features(self):
        if "s4r" in self.packed:
            return self.packed["s4r"].shape[-2] * 2
        return next(iter(self.packed.values())).shape[-2]

    @property
    def n_padded(self):
        """Packed (possibly padded) output width; >= out_features."""
        return self.scales.shape[-1]

    @property
    def k_padded(self):
        """Packed input width, from the scale groups (stacks work too)."""
        if self.groupsize > 0:
            return self.scales.shape[-2] * self.groupsize
        return self.in_features

    def _pad_x(self, x):
        Kw = self.k_padded
        if x.shape[-1] < Kw:
            x = torch.nn.functional.pad(x, (0, Kw - x.shape[-1]))
        return x

    def with_s4_rows(self, drop_fold=False):
        """Copy carrying the signed row-pair container ``s4r`` (stored
        nibbles are code - 8; K1 uses zero - 8). 4-bit only."""
        if self.bits != 4 or "s4r" in self.packed:
            return self
        codes = unpack_columns(self.packed, self.bits, self.n_padded)
        packed = {} if drop_fold else dict(self.packed)
        packed["s4r"] = pack_s4_rows(codes)
        return self._replace(packed=packed)

    def with_nibble_serving(self):
        """The ``s4r`` container alone (the serving layout). 4-bit only in
        this slice: 2/3-bit codes riding s4 nibbles come with the
        mixed-precision port."""
        if self.bits != 4:
            raise NotImplementedError(
                "nibble serving of {}-bit weights is not ported".format(
                    self.bits))
        return self.with_s4_rows(drop_fold=True)

    def with_sz_dtype(self, dtype=torch.bfloat16):
        """Copy with scales/zeros stored in ``dtype`` (bf16 halves the
        qparam stream; every path upcasts the stored values to f32)."""
        if self.scales.dtype == dtype and self.zeros.dtype == dtype:
            return self
        return self._replace(scales=self.scales.to(dtype),
                             zeros=self.zeros.to(dtype))

    def dequantize(self):
        W = dequant_weights(self.packed, self.scales, self.zeros, self.bits,
                            self.n_padded, self.groupsize)
        W = W[:, : self.out_features]
        if self.perm is not None:
            W = W[torch.argsort(self.perm), :]
        return W

    def __call__(self, x):
        if self.perm is not None:
            x = x[..., self.perm]
        x = self._pad_x(x)
        out = quant_matmul_a8(x, self.packed, self.scales, self.zeros,
                              self.bits, self.groupsize, self.n_padded)
        return self._finish(out, x.dtype, self.bias)

    def call_stacked(self, x, li):
        """Forward of layer ``li`` of a layer-stacked linear: the kernel
        reads that layer's slice of the stack in place."""
        if self.perm is not None:
            x = x[..., self.perm[li]]
        x = self._pad_x(x)
        out = quant_matmul_a8_stacked(x, self.packed, self.scales,
                                      self.zeros, li, self.bits,
                                      self.groupsize, self.n_padded)
        return self._finish(out, x.dtype,
                            None if self.bias is None else self.bias[li])

    def _finish(self, out, dtype, bias):
        if self.n_padded != self.out_features:
            out = out[..., : self.out_features]
        if bias is not None:
            out = out + bias
        return out.to(dtype)
