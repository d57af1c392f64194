"""Per-layer quantization-error profiler (port of
``sparsebit_tpu/quantization/tools/errors_profiler.py``; reference:
sparsebit/quantization/tools/errors_profiler.py:11-201).

- async mode: the error of each layer with only that layer quantized
  (float inputs everywhere);
- sync mode: quantized activations propagate, so each layer's error
  includes all preceding layers' quantization.

Returns ``{node_name: error}`` by ``checker`` (default MSE). The float
reference runs with the node's quantizers off whatever state the caller
left them in, and that state is restored after each node.
"""

import torch

from sparsebit_tpu_torch.nn.graph import Output, Placeholder, SymbolicTensor
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr
from sparsebit_tpu_torch.quantization.tools.graph_wrapper import SharedData


def mse_checker(a, b):
    return float(((a - b) ** 2).mean())


def cosine_checker(a, b):
    """1 - cosine similarity (a common quantization-error diagnostic)."""
    af, bf = a.reshape(-1), b.reshape(-1)
    denom = torch.linalg.norm(af) * torch.linalg.norm(bf) + 1e-12
    return float(1.0 - torch.dot(af, bf) / denom)


def snr_checker(a, b):
    """Negative SNR in dB of the quantized signal against the float one
    (lower is better)."""
    noise = ((a - b) ** 2).sum() + 1e-12
    signal = (b ** 2).sum() + 1e-12
    return float(-10.0 * torch.log10(signal / noise))


def _profiled(op):
    return isinstance(op, QuantOpr) and (
        (op.weight_quantizer is not None
         and not op.weight_quantizer.fake_fused)
        or (op.input_quantizer is not None
            and not op.input_quantizer.fake_fused))


class QuantizationErrorProfiler:
    def __init__(self, graph):
        self.graph = graph

    @torch.no_grad()
    def apply(self, *inputs, checker=mse_checker, is_async=True):
        return self._walk(inputs, checker, is_async)

    @staticmethod
    def _quant_state(op):
        return (op.weight_quantizer.is_enable if op.weight_quantizer
                else False,
                op.input_quantizer.is_enable if op.input_quantizer
                else False)

    def _run(self, op, args, kwargs, quant):
        """``op`` with its quantizers on (``quant``) or off, the caller's
        state restored after."""
        if not isinstance(op, QuantOpr):
            return op.execute(*args, **kwargs)
        state = self._quant_state(op)
        op.set_quant(w_quant=quant, a_quant=quant)
        try:
            return op.execute(*args, **kwargs)
        finally:
            op.set_quant(*state)

    def _walk(self, inputs, checker, is_async):
        graph = self.graph
        storage = SharedData(graph)
        qstorage = SharedData(graph)
        for ph, x in zip(graph.placeholders, inputs):
            storage.set_value(ph.name, x)
            qstorage.set_value(ph.name, x)

        def resolve(store, a):
            if isinstance(a, SymbolicTensor):
                v = store.get_value(a.node.name)
                return v[a.index] if a.index is not None else v
            return a

        errors = {}
        for node in graph.nodes:
            if isinstance(node.op, Placeholder):
                continue
            if isinstance(node.op, Output):
                break
            fargs = [resolve(storage, a) for a in node.args]
            fout = self._run(node.op, fargs, node.kwargs, False)
            if is_async:
                qout = fout  # the quantized store keeps float values
                if _profiled(node.op):
                    errors[node.name] = checker(
                        self._run(node.op, fargs, node.kwargs, True), fout)
            else:
                qargs = [resolve(qstorage, a) for a in node.args]
                quant = _profiled(node.op)
                qout = self._run(node.op, qargs, node.kwargs, quant)
                if quant:
                    errors[node.name] = checker(qout, fout)
            storage.set_value(node.name, fout)
            qstorage.set_value(node.name, qout)
            storage.consume_inputs(node)
            qstorage.consume_inputs(node)
        return errors
