"""Layerwise, memory-bounded calibration (port of
``sparsebit_tpu/quantization/tools/calibration.py``; reference:
sparsebit/quantization/tools/calibration.py:11-160).

Node by node in topological order: feature calibration (observe the
node's input, calc_qparams), the float forward of every captured batch to
make the next activations, then weight calibration (and AdaRound's layer
reconstruction). ``asym`` keeps a second store of quantized activations,
so that later layers calibrate against quantized predecessors
(calibration.py:77-97). Activations stay on the model's device, and
``SharedData`` frees each one after its last consumer.
"""

import torch

from sparsebit_tpu_torch.nn.graph import Output, Placeholder, SymbolicTensor
from sparsebit_tpu_torch.quantization.modules.base import (
    MultipleInputsQuantOpr,
    QuantOpr,
)
from sparsebit_tpu_torch.quantization.tools.graph_wrapper import SharedData


def _resolve(store, a):
    if isinstance(a, SymbolicTensor):
        vals = store.get_value(a.node.name)
        if a.index is not None:
            return [v[a.index] for v in vals]
        return vals
    return None  # a constant


def _batch_args(lists, args, i):
    return [lists[k][i] if lists[k] is not None else args[k]
            for k in range(len(args))]


class CalibrationRunner:
    def __init__(self, graph):
        self.graph = graph
        self.batches = []  # the captured input tuples
        self.adaround_max_steps = 20000  # reference default (adaround.py:66)

    # phase 1: capture the model's inputs
    def capture(self, *inputs):
        self.batches.append(tuple(x.detach() for x in inputs))

    # phase 2: the walk over the graph
    @torch.no_grad()
    def layerwise_calibration(self, asym=False, w_quant=False,
                              a_quant=False):
        assert self.batches, "no calibration batches captured"
        graph = self.graph
        storage = SharedData(graph)
        qstorage = SharedData(graph) if asym else None
        for ph_idx, ph in enumerate(graph.placeholders):
            vals = [b[ph_idx] for b in self.batches]
            storage.set_value(ph.name, vals)
            if asym:
                qstorage.set_value(ph.name, vals)
        n_batches = len(self.batches)

        for node in graph.nodes:
            if isinstance(node.op, Placeholder):
                continue
            if isinstance(node.op, Output):
                break
            op = node.op
            in_lists = [_resolve(storage, a) for a in node.args]

            # feature calibration (calibration.py:102-115)
            if (isinstance(op, QuantOpr)
                    and not isinstance(op, MultipleInputsQuantOpr)):
                iq = op.input_quantizer
                if iq is not None and not iq.fake_fused:
                    calib = ([_resolve(qstorage, a) for a in node.args]
                             if asym else in_lists)
                    for i in range(n_batches):
                        iq.update_observer(calib[0][i] if calib[0] is not None
                                           else node.args[0])
                    iq.calc_qparams()

            # float forward (calibration.py:137-160)
            outs = [op.execute(*_batch_args(in_lists, node.args, i),
                               **node.kwargs) for i in range(n_batches)]
            storage.set_value(node.name, outs)

            # weight calibration and AdaRound (calibration.py:117-135)
            if isinstance(op, QuantOpr) and op.weight_quantizer is not None:
                wq = op.weight_quantizer
                if not wq.fake_fused:
                    wq.update_observer(op.get_weight())
                    wq.calc_qparams()
                    if wq.TYPE == "adaround" and in_lists[0] is not None:
                        self._reconstruct_adaround(op, in_lists, outs)

            # asym: propagate quantized activations
            if asym:
                q_in = [_resolve(qstorage, a) for a in node.args]
                is_q = isinstance(op, QuantOpr)
                was_w = bool(is_q and op.weight_quantizer
                             and op.weight_quantizer.is_enable)
                was_a = bool(is_q and op.input_quantizer
                             and op.input_quantizer.is_enable)
                if is_q:
                    op.set_quant(w_quant, a_quant)
                qstorage.set_value(node.name, [
                    op.execute(*_batch_args(q_in, node.args, i),
                               **node.kwargs) for i in range(n_batches)])
                if is_q:
                    op.set_quant(was_w, was_a)
                qstorage.consume_inputs(node)
            storage.consume_inputs(node)

    def _reconstruct_adaround(self, op, in_lists, outs):
        from sparsebit_tpu_torch.quantization.quantizers.adaround import (
            reconstruct_qlayer,
        )

        inputs = torch.cat([torch.atleast_1d(x) for x in in_lists[0]])
        outputs = torch.cat([torch.atleast_1d(o) for o in outs])
        reconstruct_qlayer(op, inputs, outputs,
                           max_steps=self.adaround_max_steps)
