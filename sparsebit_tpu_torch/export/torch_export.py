"""Export a QuantModel as a ``torch.export`` program plus a quant-metadata
sidecar (port of ``sparsebit_tpu/export/stablehlo.py``, which replaces the
reference's QDQ-ONNX export, quant_model.py:222-324).

The program, ``model.pt2`` (``torch.export.save``; read back with
``torch.export.load(path).module()``), is the graph interpreter
``Graph.run`` over the model's ops, traced on the example inputs. The
sidecar is the JAX package's: ``quant_meta.json`` (each quantized node's
enabled quantizers: bit, symmetric, perchannel, qmin, qmax, groupsize)
and ``quant_params.npz`` (``<node>.<quantizer>.scale`` and
``.zero_point``), so that a serving stack can rebuild the QDQ semantics.
A per-channel weight scale keeps the port's layout (out channels first:
(out, 1, 1, 1) for a convolution, (out, 1) for a linear) where the JAX
package's is (1, 1, 1, out) / (1, out).
"""

import json
import os

import numpy as np
import torch

PROGRAM = "model.pt2"


class GraphProgram(torch.nn.Module):
    """A graph as a ``torch.nn.Module`` whose ``forward`` runs
    ``Graph.run`` (eval mode, the ops' own state); the ops are registered
    as submodules, so their parameters and buffers are the program's."""

    def __init__(self, graph):
        super().__init__()
        self.graph = graph
        self.ops = torch.nn.ModuleList([n.op for n in graph.op_nodes])

    def forward(self, *xs):
        return self.graph.run(None, *xs, training=False)


def _export(graph, path, example_inputs):
    module = GraphProgram(graph).eval()
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_inputs))
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, PROGRAM))
    return path


def export_graph(graph, path, example_inputs):
    """Export a bare Graph (a deployed integer graph, or a pruned model
    with its masks folded) as a ``torch.export`` program (reference:
    sparse_model.py:124 export_onnx)."""
    return _export(graph, path, example_inputs)


def quant_meta(qmodel):
    """(meta, arrays): the sidecar's JSON tree and npz arrays."""
    meta = {"nodes": {}}
    arrays = {}
    for name, op in qmodel.qmodules():
        node_meta = {}
        for prefix, q in (("input_quantizer", op.input_quantizer),
                          ("weight_quantizer", op.weight_quantizer)):
            if q is None or not q.is_enable:
                continue
            node_meta[prefix] = {
                "bit": int(q.bit),
                "symmetric": bool(q.is_symmetric),
                "perchannel": bool(q.is_perchannel),
                "qmin": int(q.qdesc.qmin),
                "qmax": int(q.qdesc.qmax),
                "groupsize": int(q.qdesc.groupsize),
            }
            for k in ("scale", "zero_point"):
                arrays["{}.{}.{}".format(name, prefix, k)] = getattr(
                    q, k).detach().cpu().numpy()
        if node_meta:
            meta["nodes"][name] = node_meta
    return meta, arrays


def export_quant_model(qmodel, path, example_inputs, extra_info=False):
    """The fake-quant model (eval, every quantizer on) as a program, and
    the sidecar. ``extra_info`` is accepted for the reference's
    signature; the sidecar always carries the true bit widths."""
    qmodel.eval()
    qmodel.set_quant(w_quant=True, a_quant=True)
    _export(qmodel.graph, path, example_inputs)
    meta, arrays = quant_meta(qmodel)
    with open(os.path.join(path, "quant_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    np.savez(os.path.join(path, "quant_params.npz"), **arrays)
    return path
