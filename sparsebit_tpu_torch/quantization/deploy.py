"""INT8 deploy pass: the fake-quant graph lowered to integer compute (port
of ``sparsebit_tpu/quantization/deploy.py``, which replaces the
reference's ONNX / TensorRT handoff, quant_model.py:222-324).

After calibration, ``deploy`` swaps QConv2d / QLinear nodes for
Int8Conv2d / Int8Linear ops that hold pre-quantized int8 weights and run

    quantize(x) -> int8 x int8 product (int32 sums) -> rescale epilogue

which is the fake-quant forward's math (both compute ``s_in * s_w *
((xq - zp) . wq)``), so the pass is held to the calibrated fake-quant
model. The integer product is ``ops/int8_matmul.int8_gemm``: an exact
product on the CPU, ``torch._int_mm`` on the card (the JAX package gives
it to XLA's integer dot, outside any Pallas kernel). PyTorch has no int8
convolution, so a convolution is an im2col over the input's codes,
padded with the zero point so that the padding stands for a real zero,
followed by that product; the correction term is then ``zp * sum(wq)``
an output channel. Unsigned activation schemes are shifted by -128 with
the shift folded into the zero point, so both operands are signed int8.

Each op keeps its weight as the product's int8 (K, N) matrix: a linear's
(in, out), a convolution's (kh * kw * in / groups, out), rows in the
im2col's (kh, kw, channel) order, the JAX package's HWIO flattened.

Requires: weights symmetric (per channel or per tensor), activations
per-tensor affine or symmetric at 8 bits.
"""

import torch

from sparsebit_tpu_torch.nn.modules import Module
from sparsebit_tpu_torch.ops.int8_matmul import int8_gemm
from sparsebit_tpu_torch.quantization.modules.conv import QConv2d
from sparsebit_tpu_torch.quantization.modules.linear import QLinear


def _weight_int8(op):
    """The wrapped module's weight quantized by its weight quantizer:
    (codes int8 in the module's layout, scale as one value an output
    channel or one in all)."""
    q = op.weight_quantizer
    w = op.get_weight().detach()
    codes = torch.clamp(torch.round(w / q.scale), q.qdesc.qmin, q.qdesc.qmax)
    return codes.to(torch.int8), q.scale.detach().reshape(-1)


def _input_qparams(op):
    """Activation qparams in signed int8: unsigned schemes (qmin 0, qmax
    255) shifted by -128, the shift folded into the zero point."""
    iq = op.input_quantizer
    shift = 128 if iq.qdesc.qmin >= 0 else 0
    s = iq.scale.detach().reshape(())
    zp = int(torch.round(iq.zero_point.detach()).reshape(())) - shift
    return s, zp, iq.qdesc.qmin - shift, iq.qdesc.qmax - shift


class _Int8Op(Module):
    def _init_int8(self, qopr, wmat, w_scale):
        assert qopr.weight_quantizer.is_symmetric, "deploy needs symmetric W"
        self.register_buffer("wq", wmat.contiguous())  # (K, N) int8
        self.register_buffer("w_scale", w_scale)
        b = qopr.module.bias
        self.register_buffer("bias", None if b is None else b.detach())
        self.register_buffer("corr", wmat.to(torch.int32).sum(
            dim=0, dtype=torch.int32))  # (N,)
        s, zp, self.qmin_a, self.qmax_a = _input_qparams(qopr)
        self.register_buffer("in_scale", s)
        self.in_zp = zp

    def quantize_input(self, x):
        xq = torch.round(x / self.in_scale) + self.in_zp
        return torch.clamp(xq, self.qmin_a, self.qmax_a).to(torch.int8)

    def epilogue(self, acc, params):
        acc = acc - self.in_zp * self.get(params, "corr")
        out = acc.to(torch.float32) * (self.in_scale
                                       * self.get(params, "w_scale"))
        if self.bias is not None:
            out = out + self.get(params, "bias")
        return out


class Int8Linear(_Int8Op):
    def __init__(self, qopr):
        super().__init__()
        codes, w_scale = _weight_int8(qopr)
        self._init_int8(qopr, codes.t(), w_scale)  # (in, out)

    def execute(self, x, params=None, training=False):
        return self.epilogue(int8_gemm(self.quantize_input(x),
                                       self.get(params, "wq")), params)


class Int8Conv2d(_Int8Op):
    def __init__(self, qopr):
        super().__init__()
        m = qopr.module
        codes, w_scale = _weight_int8(qopr)  # OIHW
        self.kernel_size = m.kernel_size
        self.stride = m.stride
        self.padding = m.padding
        self.dilation = m.dilation
        self.groups = m.groups
        # (kh * kw * in / groups, out): group i's columns are its outputs
        wmat = codes.permute(2, 3, 1, 0).reshape(-1, codes.shape[0])
        self._init_int8(qopr, wmat, w_scale)

    def _im2col(self, xq):
        """(N, OH, OW, kh * kw * C) codes of every output pixel's window,
        in the weight matrix's (kh, kw, channel) order; the input is
        padded with the zero point."""
        n, h, w, c = xq.shape
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        (ph, pw), (dh, dw) = self.padding, self.dilation
        if ph or pw:
            xp = xq.new_full((n, h + 2 * ph, w + 2 * pw, c), self.in_zp)
            xp[:, ph:ph + h, pw:pw + w] = xq
            xq = xp
        oh = (xq.shape[1] - dh * (kh - 1) - 1) // sh + 1
        ow = (xq.shape[2] - dw * (kw - 1) - 1) // sw + 1
        cols = [xq[:, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                   j * dw:j * dw + (ow - 1) * sw + 1:sw]
                for i in range(kh) for j in range(kw)]
        return torch.stack(cols, dim=3).reshape(n, oh, ow, -1)

    def execute(self, x, params=None, training=False):
        cols = self._im2col(self.quantize_input(x))
        wq = self.get(params, "wq")
        g = self.groups
        if g == 1:
            acc = int8_gemm(cols, wq)
        else:
            n, oh, ow, _ = cols.shape
            c, o = x.shape[-1] // g, wq.shape[1] // g
            cols = cols.reshape(n, oh, ow, -1, g, c)
            acc = torch.cat([
                int8_gemm(cols[..., i, :].reshape(n, oh, ow, -1),
                          wq[:, i * o:(i + 1) * o].contiguous())
                for i in range(g)], dim=-1)
        return self.epilogue(acc, params)


_DEPLOY_MAP = {QConv2d: Int8Conv2d, QLinear: Int8Linear}


class DeployedModel:
    """The integer-compute model ``deploy()`` returns."""

    def __init__(self, graph):
        self.graph = graph

    def params(self):
        return self.graph.collect_params()

    def apply(self, params, *inputs):
        return self.graph.run(params, *inputs, training=False)

    @torch.no_grad()
    def __call__(self, *inputs):
        return self.graph.run(None, *inputs, training=False)

    def export(self, path, *example_inputs):
        """The integer-compute graph as a ``torch.export`` program (the
        deployable artifact; replaces the reference's ONNX -> TensorRT
        handoff)."""
        from sparsebit_tpu_torch.export.torch_export import export_graph

        return export_graph(self.graph, path, example_inputs)


def deploy(qmodel):
    """Lower a calibrated QuantModel to integer compute. The QuantModel is
    left as it is: the graph is cloned and only the eligible nodes' ops
    are swapped on the clone."""
    g = qmodel.graph.clone()
    n_swapped = 0
    for node in g.op_nodes:
        cls = _DEPLOY_MAP.get(type(node.op))
        if cls is None:
            continue
        op = node.op
        if (op.input_quantizer is None or op.weight_quantizer is None
                or op.input_quantizer.fake_fused
                or not op.weight_quantizer.is_symmetric
                or op.input_quantizer.is_perchannel):
            continue
        node.op = cls(op)
        n_swapped += 1
    assert n_swapped > 0, "no quantized conv/linear nodes eligible for deploy"
    return DeployedModel(g)
