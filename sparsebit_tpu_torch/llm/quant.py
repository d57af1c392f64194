"""Weight quantizer and packed linear containers (port of
``sparsebit_tpu/llm/quant.py``: ``LLMQuantizer``, ``DenseLinear`` and
``QuantLinear``).

Weight convention as in the JAX package: (in_features K, out_features N),
``x @ w``; group scales/zeros (G, N) along K. ``QuantLinear.__call__``
dispatches on ``impl`` as the reference does (quant.py:487-515): "a8" is
the W4A8 path (K1, K6, K7), "auto"/"pallas"/"xla" the f32-activation
``quant_matmul`` (K8, K7 or the dense product); after ``prepare_backward``
every impl takes ``quant_matmul_a8bwd`` (the int8 backward of QLoRA).
``from_dense`` is the round-to-nearest quantizer (GPTQ: llm/gptq.py).
Both linears differentiate in x: QuantLinear through its
autograd.Functions (no weight gradients), DenseLinear through plain
autograd.
"""

import torch

from sparsebit_tpu_torch.ops import matvec as _mv
from sparsebit_tpu_torch.ops.packing import (
    pack_columns,
    pack_planes_serving,
    pack_s4_rows,
    pallas_n_pad,
    unpack_columns,
)
from sparsebit_tpu_torch.ops.quant_matmul import (
    dequant_weights,
    prepare_a8_backward,
    quant_matmul,
    quant_matmul_a8,
    quant_matmul_a8_stacked,
    quant_matmul_a8bwd,
)
from sparsebit_tpu_torch.quantization.common import div_exact

IMPLS = ("auto", "pallas", "xla", "a8")


class LLMQuantizer:
    """Asymmetric (or symmetric) min/max quantizer with integer zeros and
    an optional MSE shrink-grid search (quant.py:23-84), in f32.

    The scale ``(wmax - wmin) / qmax`` and the shrink grid ``i / grid``
    are exact divisions on either device (``common.div_exact``: the
    card's division by a plain number is a multiply by its reciprocal),
    as the JAX package's eager round to nearest divides. Its jitted GPTQ
    solver multiplies by ``1 / qmax`` instead (XLA rewrites a division by
    a constant); the port's solver divides (ROADMAP.md, numerics
    contracts)."""

    def __init__(self, bits=4, sym=False, mse=False, maxshrink=0.8, grid=100,
                 norm=2.4):
        self.bits = bits
        self.sym = sym
        self.mse = mse
        self.maxshrink = maxshrink
        self.grid = grid
        self.norm = norm
        self.qmax = 2 ** bits - 1

    def find_params(self, w):
        """w (..., n, N): the n rows share one (scale, zero) per column ->
        scale, zero (..., 1, N)."""
        zero_t = torch.zeros((), dtype=w.dtype, device=w.device)
        wmin = torch.minimum(w.amin(dim=-2, keepdim=True), zero_t)
        wmax = torch.maximum(w.amax(dim=-2, keepdim=True), zero_t)
        if self.sym:
            wmax = torch.maximum(wmin.abs(), wmax)
            wmin = -wmax
        degenerate = (wmin == 0) & (wmax == 0)
        wmin = torch.where(degenerate, -1.0, wmin)
        wmax = torch.where(degenerate, 1.0, wmax)
        if self.mse:
            return self._mse_search(w, wmin, wmax)
        return self._params_from_range(wmin, wmax)

    def _params_from_range(self, wmin, wmax):
        scale = div_exact(wmax - wmin, float(self.qmax))
        if self.sym:
            zero = torch.full_like(scale, (self.qmax + 1) / 2.0)
        else:
            zero = torch.round(-wmin / scale)
        return scale, zero

    def _mse_search(self, w, wmin, wmax):
        """Shrink factors p = 1 - i/grid; per column the p of least
        sum |dequant - w|^norm (the first one on a tie)."""
        n = int(self.grid * self.maxshrink)
        ps = 1.0 - div_exact(torch.arange(n, dtype=torch.float32,
                                          device=w.device), float(self.grid))
        best_loss = best_p = None
        for p in ps:
            s, z = self._params_from_range(wmin * p, wmax * p)
            q = torch.clamp(torch.round(w / s) + z, 0, self.qmax)
            loss = ((q - z) * s - w).abs().pow(self.norm).sum(
                dim=-2, keepdim=True)
            if best_loss is None:
                best_loss, best_p = loss, torch.full_like(loss, p.item())
            else:
                better = loss < best_loss
                best_loss = torch.where(better, loss, best_loss)
                best_p = torch.where(better, p, best_p)
        return self._params_from_range(wmin * best_p, wmax * best_p)

    def codes(self, w, scale, zero):
        return torch.clamp(torch.round(w / scale) + zero, 0,
                           self.qmax).to(torch.uint8)


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
        if _mv.use_matvec(x, self.w, self.bias) and not x.requires_grad:
            return _mv.matvec(x, self.w)
        out = torch.matmul(x, self.w.to(x.dtype))
        if self.bias is not None:
            out = out + self.bias
        return out


class QuantLinear:
    """Packed low-bit linear: ``packed`` is a dict of uint8 containers
    (the fold layout ``"w"``/``"low2"``/``"high1"`` of pack_columns, the
    ``"s4r"`` signed row-pair serving layout, or the ``"pl"`` plane concat
    of 2/3-bit true-width serving); scales/zeros (G, N). Leaves
    may carry a leading layer axis (decode.stack_layers), read through
    ``call_stacked``. ``impl`` is one of IMPLS."""

    def __init__(self, packed, scales, zeros, bits, groupsize, out_features,
                 bias=None, perm=None, impl="auto", bwd_wq=None,
                 bwd_scale=None):
        if impl not in IMPLS:
            raise ValueError("QuantLinear impl {!r} not in {}".format(
                impl, IMPLS))
        self.packed = packed
        self.scales = scales
        self.zeros = zeros
        self.bits = bits
        self.groupsize = groupsize
        self.out_features = out_features
        self.bias = bias
        self.perm = perm  # act-order input permutation (K,), or None
        self.impl = impl
        # the int8 backward's W^T, requantized per input channel
        # (prepare_backward), or None: dx then takes the f32 weight
        self.bwd_wq = bwd_wq
        self.bwd_scale = bwd_scale

    def _replace(self, **kw):
        fields = dict(packed=self.packed, scales=self.scales,
                      zeros=self.zeros, bits=self.bits,
                      groupsize=self.groupsize,
                      out_features=self.out_features, bias=self.bias,
                      perm=self.perm, impl=self.impl, bwd_wq=self.bwd_wq,
                      bwd_scale=self.bwd_scale)
        fields.update(kw)
        return QuantLinear(**fields)

    @classmethod
    def from_codes(cls, codes, scales, zeros, bits, groupsize, bias=None,
                   perm=None, impl="auto"):
        """Pack integer codes (K, N); N is padded to the JAX package's
        packed-width multiple with columns that dequantize to exactly 0."""
        N = codes.shape[1]
        pad = pallas_n_pad(N, bits)
        if pad:
            codes = torch.nn.functional.pad(codes, (0, pad))
            scales = torch.nn.functional.pad(scales, (0, pad), value=1.0)
            zeros = torch.nn.functional.pad(zeros, (0, pad))
        return cls(pack_columns(codes, bits), scales, zeros, bits, groupsize,
                   N, bias, perm, impl)

    @classmethod
    def from_dense(cls, w, bits=4, groupsize=-1, sym=False, mse=False,
                   bias=None, impl="auto"):
        """Round-to-nearest quantization of a dense (K, N) f32 weight with
        per-group (or per-column, groupsize <= 0) scales and zeros
        (quant.py:148-163), packed by from_codes."""
        K, N = w.shape
        gs = groupsize if groupsize > 0 else K
        quantizer = LLMQuantizer(bits=bits, sym=sym, mse=mse)
        w = w.to(torch.float32)
        scales, zeros = quantizer.find_params(w.reshape(K // gs, gs, N))
        scales = scales.reshape(K // gs, N)
        zeros = zeros.reshape(K // gs, N)
        codes = quantizer.codes(w, torch.repeat_interleave(scales, gs, 0),
                                torch.repeat_interleave(zeros, gs, 0))
        return cls.from_codes(codes, scales, zeros, bits, groupsize, bias,
                              impl=impl)

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

    def with_k_pad(self, mult):
        """Copy whose packed codes are K-padded (input rows) to a multiple
        of ``mult`` with exact-zero rows: code 0, zero 0, scale 1
        (quant.py:416-458). Whole groups only, no act-order perm. An
        ``s4r`` linear keeps only ``s4r``; others repack to the fold
        layout. __call__/call_stacked zero-pad x to match, so the padded
        groups add exactly 0; K4 takes a K-padded W2
        (ops/layer_fused.fused_layer_supported)."""
        if self.perm is not None:
            raise ValueError("with_k_pad: an act-order perm indexes K")
        if self.groupsize <= 0 or self.bits == 8:
            raise ValueError("with_k_pad: groupwise 2/3/4-bit linears only")
        pad = (-self.k_padded) % mult
        if pad == 0:
            return self
        if pad % self.groupsize:
            raise ValueError(
                "with_k_pad: pad {} must be whole groups (gs={})".format(
                    pad, self.groupsize))
        codes = unpack_columns(self.packed, self.bits, self.n_padded)
        codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
        gpad = pad // self.groupsize
        scales = torch.nn.functional.pad(self.scales, (0, 0, 0, gpad),
                                         value=1.0)
        zeros = torch.nn.functional.pad(self.zeros, (0, 0, 0, gpad))
        if "s4r" in self.packed and self.bits == 4:
            packed = {"s4r": pack_s4_rows(codes)}
        else:
            packed = pack_columns(codes, self.bits)
        return self._replace(packed=packed, scales=scales, zeros=zeros,
                             perm=None)

    def with_s4_rows(self, drop_fold=False):
        """Copy carrying the signed row-pair container ``s4r`` (stored
        nibbles are code - 8; K1 uses zero - 8). 4-bit only."""
        if self.bits != 4 or "s4r" in self.packed:
            return self
        codes = unpack_columns(self.packed, self.bits, self.n_padded)
        packed = {} if drop_fold else dict(self.packed)
        packed["s4r"] = pack_s4_rows(codes)
        return self._replace(packed=packed)

    def with_u4(self):
        """The port's meaning of the reference's ``with_u4``
        (quant.py:193-220), which adds a 4-bit codes view so that a8
        linears take K1: a copy of a 2/3/4-bit fold-layout linear that also
        carries ``s4r`` (codes < 16 ride signed nibbles; K1 then takes the
        integer sums the u4 view gave). The fold container stays, so the
        other impls and ``dequantize`` are unchanged. No-op at 8 bits and
        where ``s4r`` exists."""
        if self.bits == 8 or "s4r" in self.packed:
            return self
        codes = unpack_columns(self.packed, self.bits, self.n_padded)
        return self._replace(packed=dict(self.packed, s4r=pack_s4_rows(codes)))

    # the reference's unsigned row pairs (quant.py:246-275) are s4r here;
    # 8-bit linears keep their "w" container in both
    with_u4_rows = with_u4

    def with_nibble_serving(self):
        """The ``s4r`` container alone, re-tagged bits=4 (quant.py:306-342):
        2/3-bit codes ride s4 nibbles unchanged, so that a mixed 4/3/2-bit
        model stacks as one homogeneous 4-bit backbone; the columns are
        re-padded to the 4-bit multiple. ``dequantize`` is bit-identical."""
        if self.bits == 4:
            return self.with_s4_rows(drop_fold=True)
        if self.bits not in (2, 3):
            raise ValueError("nibble serving covers bits <= 4, got {}".format(
                self.bits))
        nout = self.out_features
        codes = unpack_columns(self.packed, self.bits, self.n_padded)
        codes = codes[..., :nout]
        scales, zeros = self.scales[..., :nout], self.zeros[..., :nout]
        pad = pallas_n_pad(nout, 4)
        if pad:
            codes = torch.nn.functional.pad(codes, (0, pad))
            scales = torch.nn.functional.pad(scales, (0, pad), value=1.0)
            zeros = torch.nn.functional.pad(zeros, (0, pad))
        return self._replace(packed={"s4r": pack_s4_rows(codes)},
                             scales=scales, zeros=zeros, bits=4)

    def with_plane_serving(self, drop_fold=True):
        """Copy carrying the true-width plane concat ``"pl"``
        (quant.py:344-370): K4 streams the real 3 (2) bits per weight. At 2
        bits the plane array is the fold container itself, kept under
        ``"w"`` as the same tensor, so the per-matmul kernels still find
        it. No-op at other bits and where ``"pl"`` exists."""
        if self.bits not in (2, 3) or "pl" in self.packed:
            return self
        codes = unpack_columns(self.packed, self.bits, self.n_padded)
        packed = {} if drop_fold else dict(self.packed)
        packed["pl"] = pack_planes_serving(codes, self.bits)
        if self.bits == 2:
            packed.setdefault("w", packed["pl"])
        return self._replace(packed=packed)

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

    def prepare_backward(self):
        """Copy carrying the per-input-channel int8 requantized W^T
        (quant.py:469-485, the reference's prepare_backward_scales): the
        forward is unchanged, dx runs on the int8 product instead of the
        f32 dequantized weight. Computed once at train-prep."""
        bwd_wq, bwd_scale = prepare_a8_backward(
            self.packed, self.scales, self.zeros, self.bits, self.n_padded,
            self.groupsize)
        return self._replace(bwd_wq=bwd_wq, bwd_scale=bwd_scale)

    def __call__(self, x):
        if self.perm is not None:
            x = x[..., self.perm]
        x = self._pad_x(x)
        if self.bwd_wq is not None:  # whatever the impl (quant.py:491-498)
            out = quant_matmul_a8bwd(x, self.packed, self.scales, self.zeros,
                                     self.bwd_wq, self.bwd_scale, self.bits,
                                     self.groupsize, self.n_padded,
                                     self.impl)
        elif self.impl == "a8":
            out = quant_matmul_a8(x, self.packed, self.scales, self.zeros,
                                  self.bits, self.groupsize, self.n_padded)
        else:
            out = quant_matmul(x, self.packed, self.scales, self.zeros,
                               self.bits, self.groupsize, self.n_padded,
                               self.impl)
        return self._finish(out, x.dtype, self.bias)

    def call_stacked(self, x, li):
        """Forward of layer ``li`` of a layer-stacked linear: the kernel
        reads that layer's slice of the stack in place. W4A8 whatever the
        impl, as the reference's (quant.py:517-536)."""
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
