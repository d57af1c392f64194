"""SparseModel: the pruning orchestrator (port of
``sparsebit_tpu/sparse/sparse_model.py``; reference:
sparsebit/sparse/sparse_model.py:23-146).

Pipeline: trace (``torch.fx``, lowered to the graph IR) -> simplify ->
convert to SModules (skipping SKIP_TRACE_MODULES) -> build the sparsers
with the per-node SPARSER.SPECIFIC overrides -> when structured, set the
ratio of every residual producer to 0, so that structured pruning never
breaks an Add (reference sparse_model.py:86-105). ``calc_params`` walks
the graph computing the masks: slimming reads the following BatchNorm's
gamma, and a structured channel mask is threaded into the following
BatchNorm. Execution is eager PyTorch on the modules' state, on the
device the model lives on: the JAX package's jit cache has no
counterpart.
"""

from fnmatch import fnmatch

from sparsebit_tpu_torch.nn import functional as F
from sparsebit_tpu_torch.nn.graph import Tracer
from sparsebit_tpu_torch.quantization.converters import simplify
from sparsebit_tpu_torch.sparse.modules import SMODULE_MAP, SparseOpr
from sparsebit_tpu_torch.sparse.modules.normalization import SBatchNorm2d
from sparsebit_tpu_torch.sparse.sparsers.slimming import SlimmingSparser


class SparseModel:
    def __init__(self, model, config, example_inputs):
        self.cfg = config
        self.graph = Tracer(config.SKIP_TRACE_MODULES).trace(
            model, example_inputs)
        simplify(self.graph)
        self._convert2sparsemodule()
        self._build_sparser()
        if config.SPARSER.STRATEGY == "structure":
            self._disable_sparse_before_add()
        self._training = False

    # ---- build --------------------------------------------------------------
    def _convert2sparsemodule(self):
        skip = self.cfg.SKIP_TRACE_MODULES
        for node in self.graph.op_nodes:
            if any(fnmatch(node.name, p) for p in skip):
                continue
            scls = SMODULE_MAP.get(type(node.op))
            if scls is not None:
                node.op = scls(node.op, self.cfg)

    def _node_config(self, node_name):
        """Per-node SPARSER config with the SPECIFIC fnmatch overrides."""
        cfg = self.cfg.clone()
        cfg.defrost()
        if self.cfg.SPARSER.SPECIFIC:
            for pattern, overrides in self.cfg.SPARSER.SPECIFIC[0].items():
                if fnmatch(node_name, pattern):
                    cfg.SPARSER.merge_from_list(list(overrides))
                    break
        cfg.SPARSER.SPECIFIC = []
        cfg.freeze()
        return cfg

    def _build_sparser(self):
        for node in self.graph.op_nodes:
            if isinstance(node.op, SparseOpr):
                node.op.build_sparser(self._node_config(node.name))

    def _disable_sparse_before_add(self):
        """Residual producers keep all their channels: walk back from
        every Add (``+``, ``+=``, ``torch.add`` and ``Tensor.add`` all
        lower to ``F.Add``) through the ops without weights to the
        nearest weighted producers."""
        for node in self.graph.op_nodes:
            if not isinstance(node.op, F.Add):
                continue
            stack = list(node.input_nodes)
            seen = set()
            while stack:
                p = stack.pop()
                if p.name in seen:
                    continue
                seen.add(p.name)
                if isinstance(p.op, SparseOpr) and p.op.HAS_WEIGHT:
                    p.op.set_ratio(0.0)
                elif not isinstance(p.op, F.Add):
                    # through passthrough ops (bn, relu, pool, ...)
                    stack.extend(p.input_nodes)

    # ---- masks (sparse_model.py:107-113) ------------------------------------
    def calc_params(self):
        structured = self.cfg.SPARSER.STRATEGY == "structure"
        for node in self.graph.op_nodes:
            op = node.op
            if not (isinstance(op, SparseOpr) and op.HAS_WEIGHT):
                continue
            if isinstance(op.sparser, SlimmingSparser):
                bn = self._following_bn(node)
                if bn is not None:
                    op.sparser.set_bn_weight(bn.op.module.weight)
            ch_mask = op.calc_mask()
            if structured and ch_mask is not None:
                bn = self._following_bn(node)
                if bn is not None:
                    bn.op.set_channel_mask(ch_mask)

    def _following_bn(self, node):
        for s in self.graph.successors(node):
            if isinstance(s.op, SBatchNorm2d):
                return s
        return None

    # ---- introspection ------------------------------------------------------
    def smodules(self):
        """(name, SparseOpr) pairs."""
        for node in self.graph.op_nodes:
            if isinstance(node.op, SparseOpr):
                yield node.name, node.op

    def sparsity(self):
        """Global fraction of zeroed weight elements."""
        total, zeros = 0, 0
        for _, op in self.smodules():
            if op.HAS_WEIGHT:
                total += op.w_mask.numel()
                zeros += int((op.w_mask == 0).sum())
        return zeros / max(total, 1)

    def print_tabular(self):
        return self.graph.print_tabular()

    # ---- parameters and execution -------------------------------------------
    def params(self):
        """{node: {name: tensor}}: the ops' state, masks included."""
        return self.graph.collect_params()

    def load_params(self, params):
        self.graph.load_params(params)

    def train(self, mode=True):
        for node in self.graph.op_nodes:
            node.op.train(mode)
        self._training = mode
        return self

    def eval(self):
        return self.train(False)

    def apply(self, params, *inputs, training=False):
        """Forward with explicit state replacements."""
        return self.graph.run(params, *inputs, training=training)

    def __call__(self, *inputs):
        return self.graph.run(None, *inputs, training=self._training)

    # ---- export (sparse_model.py:124) ---------------------------------------
    def export(self, path, *example_inputs):
        """A ``torch.export`` program of the masked model (replaces the
        reference's ONNX export; ``export/torch_export.export_graph``)."""
        from sparsebit_tpu_torch.export.torch_export import export_graph

        return export_graph(self.graph, path, example_inputs)
