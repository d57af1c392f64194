"""QuantModel: the PTQ/QAT orchestrator (port of
``sparsebit_tpu/quantization/quant_model.py``; reference:
sparsebit/quantization/quant_model.py:29-364).

Pipeline: trace (``torch.fx``, lowered to the graph IR) -> simplify ->
convert to QModules -> build quantizers (per-node W/A.SPECIFIC overrides
on the dotted module path, QIdentity inputs for multi-input ops) -> fuse
passes. Then calibration, QAT initialisation, BatchNorm tuning, the quant
toggles and the parameter API (``{node: {name: tensor}}``). Execution is
eager PyTorch on the modules' state, on the device the model lives on:
the JAX package's jit cache has no counterpart.
"""

from contextlib import contextmanager
from fnmatch import fnmatch

from sparsebit_tpu_torch.nn.graph import SymbolicTensor, Tracer
from sparsebit_tpu_torch.quantization.common import get_backend
from sparsebit_tpu_torch.quantization.converters import (
    fuse_operations,
    simplify,
)
from sparsebit_tpu_torch.quantization.modules import QMODULE_MAP
from sparsebit_tpu_torch.quantization.modules.base import (
    MultipleInputsQuantOpr,
    QuantOpr,
)
from sparsebit_tpu_torch.quantization.modules.unary import QIdentity
from sparsebit_tpu_torch.quantization.tools.calibration import (
    CalibrationRunner,
)
from sparsebit_tpu_torch.utils.yaml_utils import update_config


class QuantModel:
    def __init__(self, model, config, example_inputs):
        self.cfg = config
        self.backend = get_backend(config.BACKEND)
        self.graph = Tracer(config.SKIP_TRACE_MODULES).trace(
            model, example_inputs)
        simplify(self.graph)
        self._convert2quantmodule()
        self._build_quantizer()
        self._run_fuse_operations()
        self._training = False
        self._capture_mode = False

    # ---- build phases (quant_model.py:40-158) -----------------------------
    def _convert2quantmodule(self):
        skip = self.cfg.SKIP_TRACE_MODULES
        for node in self.graph.op_nodes:
            if any(fnmatch(node.name, p) for p in skip):
                continue
            qcls = QMODULE_MAP.get(type(node.op))
            if qcls is not None:
                node.op = qcls(node.op, self.cfg)

    def _sub_build(self, src, module_name):
        """Per-node W or A config with the SPECIFIC fnmatch overrides
        (quant_model.py:97-113)."""
        sub_cfg = src.clone()
        sub_cfg.defrost()
        if src.SPECIFIC:
            for pattern, overrides in src.SPECIFIC[0].items():
                if fnmatch(module_name, pattern):
                    sub_cfg.merge_from_list(list(overrides))
                    break
        sub_cfg.SPECIFIC = []
        sub_cfg.freeze()
        return sub_cfg

    def _node_config(self, node_name):
        cfg = self.cfg.clone()
        cfg.defrost()
        cfg["W"] = self._sub_build(self.cfg.W, node_name)
        cfg["A"] = self._sub_build(self.cfg.A, node_name)
        cfg.freeze()
        return cfg

    def _build_quantizer(self):
        for node in list(self.graph.op_nodes):
            op = node.op
            if isinstance(op, MultipleInputsQuantOpr):
                if (len(node.input_nodes) > 1
                        and self._multi_input_quant_enabled(op)):
                    self._insert_input_identities(node)
            elif isinstance(op, QuantOpr):
                op.build_quantizer(self._node_config(node.name))
        self.graph.toposort()

    def _multi_input_quant_enabled(self, op):
        gate = getattr(type(op), "input_quant_enabled", None)
        return gate(self.cfg) if gate is not None else True

    def _insert_input_identities(self, node):
        """A QIdentity (with an input quantizer) on each input edge of a
        multi-input op (quant_model.py:126-137)."""
        cfg = self._node_config(node.name)
        new_args = []
        for a in node.args:
            if isinstance(a, SymbolicTensor):
                ident = QIdentity(config=self.cfg)
                ident.build_quantizer(cfg)
                ident_node = self.graph.create_node(
                    ident, [a], name="{}_identity".format(node.name),
                    out_aval=a.aval)
                new_args.append(ident_node.symbolic())
            else:
                new_args.append(a)
        node.args = new_args

    def _run_fuse_operations(self):
        if self.cfg.SCHEDULE.BN_TUNING:
            update_config(self.cfg.SCHEDULE, ["FUSE_BN", False])
        fuse_operations(self.graph, self.cfg.SCHEDULE)

    # ---- calibration (quant_model.py:181-199) -----------------------------
    def prepare_calibration(self):
        self.eval()
        self.calibration_runner = CalibrationRunner(self.graph)
        self._capture_mode = True

    def calc_qparams(self, asym=False, w_quant=False, a_quant=False):
        assert hasattr(self, "calibration_runner"), (
            "run self.prepare_calibration first")
        self._capture_mode = False
        self.calibration_runner.layerwise_calibration(asym, w_quant, a_quant)
        del self.calibration_runner

    def init_QAT(self):
        self.calc_qparams()
        self.set_quant(w_quant=True, a_quant=True)
        self.enable_qat = True

    @contextmanager
    def batchnorm_tuning(self):
        """Re-estimate BatchNorm statistics under quantization (arXiv
        2006.10518; quant_model.py:160-179): forward batches inside the
        context, in training mode; BatchNorm is fused on exit."""
        self.train()
        self.set_quant(w_quant=True, a_quant=True)
        yield
        self.eval()
        update_config(self.cfg.SCHEDULE, ["FUSE_BN", True])
        fuse_operations(self.graph, self.cfg.SCHEDULE)
        self.set_quant(w_quant=False, a_quant=False)

    # ---- state toggles ----------------------------------------------------
    def set_quant(self, w_quant=False, a_quant=False):
        for _, op in self.qmodules():
            op.set_quant(w_quant, a_quant)

    def train(self, mode=True):
        for node in self.graph.op_nodes:
            node.op.train(mode)
        self._training = mode
        return self

    def eval(self):
        return self.train(False)

    def qmodules(self):
        """(name, QuantOpr) pairs, for per-layer overrides such as an 8-bit
        head and tail (QAT main.py:236-250)."""
        for node in self.graph.op_nodes:
            if isinstance(node.op, QuantOpr):
                yield node.name, node.op

    def get_qmodule(self, name):
        for n, m in self.qmodules():
            if n == name:
                return m
        raise KeyError(name)

    # ---- parameters and execution -----------------------------------------
    def params(self):
        return self.graph.collect_params()

    def load_params(self, params):
        self.graph.load_params(params)

    def trainable_params(self):
        """QAT learnables, {node: {name: tensor}}: weights and the enabled
        quantizers' learnables."""
        out = {}
        for name, op in self.qmodules():
            p = op.trainable_params()
            if p:
                out[name] = p
        return out

    def apply(self, params, *inputs, training=False):
        """Forward with explicit state replacements."""
        return self.graph.run(params, *inputs, training=training)

    def __call__(self, *inputs):
        if self._capture_mode:
            self.calibration_runner.capture(*inputs)
            return None
        return self.graph.run(None, *inputs, training=self._training)

    # ---- introspection ----------------------------------------------------
    def get_quantization_error(self, *inputs, checker=None, is_async=True):
        """{node: error} of each quantized node against its float output
        (``tools/errors_profiler.py``; default checker: MSE)."""
        from sparsebit_tpu_torch.quantization.tools.errors_profiler import (
            QuantizationErrorProfiler,
            mse_checker,
        )

        return QuantizationErrorProfiler(self.graph).apply(
            *inputs, checker=checker or mse_checker, is_async=is_async)

    def dump_mermaid(self):
        return self.graph.to_mermaid()

    def print_tabular(self):
        return self.graph.print_tabular()

    # ---- export -----------------------------------------------------------
    def export(self, path, *example_inputs, extra_info=False):
        """A ``torch.export`` program of the fake-quant model and the
        quant-metadata sidecar (replaces the reference's QDQ-ONNX export,
        quant_model.py:222-324; see ``sparsebit_tpu_torch.export``)."""
        from sparsebit_tpu_torch.export.torch_export import (
            export_quant_model,
        )

        return export_quant_model(self, path, example_inputs,
                                  extra_info=extra_info)
