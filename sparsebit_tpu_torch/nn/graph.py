"""Graph IR, the ``torch.fx`` tracer and the interpreter (port of
``sparsebit_tpu/nn/graph.py``).

``Tracer.trace`` traces a model with ``torch.fx`` (a port module that
computes in ``execute`` is a leaf, and so is a module that
``SKIP_TRACE_MODULES`` names), records every node's output shape with
``ShapeProp`` on the example inputs (the job of the JAX package's
``eval_shape``), and lowers the fx graph in one pass to the JAX package's
IR:

- ``Node``: one op, always a Module: a leaf module of the model, named by
  its dotted path (``layer1.0.conv1``), or a singleton op-module of
  ``nn/functional.py`` for each ``call_function`` / ``call_method`` node,
  named by its class (``add``, ``add_0``, ...);
- values that are no tensors (``x.shape``, ``x.size(1)``) fold into
  constants, as shapes are static in the JAX package's graphs, and so
  does every call that reads no traced tensor (``torch.arange(L)``, an
  embedding lookup of it, an ``expand`` of a parameter): it is computed
  once while lowering, as the JAX package computes a call on captured
  arrays; an element of a multi-output op is a ``SymbolicTensor`` with an
  ``index``;
- ``Graph``: the topologically ordered nodes with the edit utilities the
  converters and calibration use, and ``Graph.run``, the interpreter,
  which runs eagerly on the ops' state (``params`` replaces it per node).
"""

import fnmatch
import itertools
import operator

import torch
import torch.fx
from torch.fx.passes.shape_prop import ShapeProp

from sparsebit_tpu_torch.nn import functional as F
from sparsebit_tpu_torch.nn.modules import Module


class ShapeDtype:
    """Shape and dtype of a traced value (the JAX package's aval)."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return "ShapeDtype({}, {})".format(self.shape, self.dtype)


class SymbolicTensor:
    """A reference to a node's output (or to element ``index`` of it)."""

    def __init__(self, node, aval, index=None):
        self.node = node
        self.aval = aval
        self.index = index

    @property
    def shape(self):
        return self.aval.shape

    @property
    def dtype(self):
        return self.aval.dtype

    @property
    def ndim(self):
        return len(self.aval.shape)

    def __repr__(self):
        return "SymbolicTensor({}, {})".format(self.node.name, self.aval)


class Node:
    def __init__(self, name, op, args, kwargs=None, out_aval=None):
        self.name = name
        self.op = op  # a Module instance
        self.args = list(args)  # SymbolicTensor | constants
        self.kwargs = dict(kwargs or {})
        self.out_aval = out_aval
        self.graph = None

    @property
    def input_nodes(self):
        seen, out = set(), []
        for a in self.args:
            if isinstance(a, SymbolicTensor) and a.node.name not in seen:
                seen.add(a.node.name)
                out.append(a.node)
        return out

    @property
    def op_type(self):
        return type(self.op)

    def replace_input(self, old_node, new_value):
        self.args = [new_value if isinstance(a, SymbolicTensor)
                     and a.node is old_node else a for a in self.args]

    def symbolic(self, index=None):
        aval = self.out_aval if index is None else self.out_aval[index]
        return SymbolicTensor(self, aval, index=index)

    def __repr__(self):
        return "Node({}: {})".format(self.name, type(self.op).__name__)


class Placeholder:
    def __repr__(self):
        return "Placeholder()"


class Output:
    def __repr__(self):
        return "Output()"


class Graph:
    def __init__(self):
        self.nodes = []  # topological order, placeholders and output too
        self._name_counter = itertools.count()
        self._names = set()
        self.version = 0  # bumped on every edit

    # ---- construction -----------------------------------------------------
    def unique_name(self, base):
        name = base
        while name in self._names:
            name = "{}_{}".format(base, next(self._name_counter))
        self._names.add(name)
        return name

    def add_placeholder(self, name):
        node = Node(self.unique_name(name), Placeholder(), [])
        node.graph = self
        self.nodes.append(node)
        return node

    def create_node(self, op, args, kwargs=None, name=None, out_aval=None):
        base = name or _default_name(op)
        node = Node(self.unique_name(base), op, args, kwargs, out_aval)
        node.graph = self
        self.nodes.append(node)
        self.version += 1
        return node

    def set_output(self, values):
        node = Node(self.unique_name("output"), Output(), list(values))
        node.graph = self
        self.nodes.append(node)
        return node

    # ---- queries ----------------------------------------------------------
    @property
    def placeholders(self):
        return [n for n in self.nodes if isinstance(n.op, Placeholder)]

    @property
    def output_node(self):
        for n in reversed(self.nodes):
            if isinstance(n.op, Output):
                return n
        raise RuntimeError("graph has no output node")

    @property
    def op_nodes(self):
        return [n for n in self.nodes
                if not isinstance(n.op, (Placeholder, Output))]

    def find_node(self, name):
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def successors(self, node):
        return [n for n in self.nodes if node in n.input_nodes]

    def out_degree(self, node):
        return len(self.successors(node))

    # ---- edits ------------------------------------------------------------
    def replace_all_uses(self, old_node, new_value):
        for n in self.nodes:
            if n is not old_node:
                n.replace_input(old_node, new_value)
        self.version += 1

    def erase_node(self, node):
        assert self.out_degree(node) == 0, (
            "cannot erase node with users: {}".format(node.name))
        self.nodes.remove(node)
        self._names.discard(node.name)
        self.version += 1

    def insert_after(self, anchor, node):
        """Move ``node`` (already created) right after ``anchor``."""
        self.nodes.remove(node)
        self.nodes.insert(self.nodes.index(anchor) + 1, node)
        self.version += 1

    def toposort(self):
        """Re-establish topological order after edits."""
        order = {n.name: i for i, n in enumerate(self.nodes)}
        visited, result = set(), []

        def visit(n):
            if n.name in visited:
                return
            visited.add(n.name)
            for p in n.input_nodes:
                visit(p)
            result.append(n)

        for n in sorted(self.nodes, key=lambda n: order[n.name]):
            visit(n)
        self.nodes = result
        self.version += 1

    def prune(self):
        """Dead-node elimination; returns the removed nodes."""
        live = set()
        stack = [self.output_node]
        while stack:
            n = stack.pop()
            if n.name in live:
                continue
            live.add(n.name)
            stack.extend(n.input_nodes)
        removed = [n for n in self.nodes if n.name not in live]
        self.nodes = [n for n in self.nodes if n.name in live]
        for n in removed:
            self._names.discard(n.name)
        if removed:
            self.version += 1
        return removed

    # ---- execution --------------------------------------------------------
    def run(self, params, *inputs, training=False):
        """The interpreter. ``params``: None (every op on its own state) or
        ``{node_name: {state_name: tensor}}`` replacements."""
        env = {}
        phs = self.placeholders
        assert len(inputs) == len(phs), "expected {} inputs, got {}".format(
            len(phs), len(inputs))
        for ph, x in zip(phs, inputs):
            env[ph.name] = x

        def resolve(a):
            if isinstance(a, SymbolicTensor):
                v = env[a.node.name]
                return v if a.index is None else v[a.index]
            return a

        for node in self.nodes:
            if isinstance(node.op, Placeholder):
                continue
            args = [resolve(a) for a in node.args]
            if isinstance(node.op, Output):
                return args[0] if len(args) == 1 else tuple(args)
            env[node.name] = node.op.execute(
                *args, params=params.get(node.name) if params else None,
                training=training, **node.kwargs)
        raise RuntimeError("graph has no output node")

    def collect_params(self):
        """{node: {name: tensor}} of the ops' state."""
        params = {}
        for n in self.op_nodes:
            p = n.op.leaf_state_dict()
            if p:
                params[n.name] = p
        return params

    def load_params(self, params):
        for n in self.op_nodes:
            if n.name in params:
                n.op.load_leaf_state_dict(params[n.name])

    def clone(self):
        """Structural copy: new nodes and references, SHARED op modules
        (callers swap ops on the clone)."""
        g2 = Graph()
        mapping = {}
        for n in self.nodes:
            new_args = [mapping[a.node.name].symbolic(a.index)
                        if isinstance(a, SymbolicTensor) else a
                        for a in n.args]
            n2 = Node(n.name, n.op, new_args, dict(n.kwargs), n.out_aval)
            n2.graph = g2
            g2.nodes.append(n2)
            g2._names.add(n.name)
            mapping[n.name] = n2
        return g2

    # ---- introspection ----------------------------------------------------
    def print_tabular(self):
        rows = []
        for n in self.nodes:
            ins = ", ".join(p.name for p in n.input_nodes)
            rows.append("{:<28} {:<24} [{}]".format(
                n.name, type(n.op).__name__, ins))
        return "\n".join(rows)

    def to_mermaid(self):
        lines = ["graph TD"]
        for n in self.nodes:
            for p in n.input_nodes:
                lines.append("    {} --> {}".format(p.name, n.name))
        return "\n".join(lines)


def _default_name(op):
    return type(op).__name__.lower()


# ---- tracing ----------------------------------------------------------------


class _FxTracer(torch.fx.Tracer):
    """fx's tracer with the port's leaf policy: a port module that computes
    in ``execute`` is a leaf, and so is any module whose dotted path
    matches a ``SKIP_TRACE_MODULES`` pattern. A buffer that a traced
    ``forward`` reads is a ``get_attr`` node, so that indexing it by a
    traced size (GPT-2's ``causal_bias[:N, :N]``) traces."""

    def __init__(self, skipped_patterns):
        super().__init__()
        self.proxy_buffer_attributes = True
        self.skipped_patterns = skipped_patterns

    def is_leaf_module(self, m, module_qualified_name):
        if any(fnmatch.fnmatch(module_qualified_name, p)
               for p in self.skipped_patterns):
            return True
        if isinstance(m, Module):
            return m.is_leaf()
        return super().is_leaf_module(m, module_qualified_name)


def _meta_of(value):
    if isinstance(value, torch.Tensor):
        return ShapeDtype(value.shape, value.dtype)
    if isinstance(value, (tuple, list)) and value and all(
            isinstance(v, torch.Tensor) for v in value):
        return tuple(ShapeDtype(v.shape, v.dtype) for v in value)
    return None


class _ValueProp(ShapeProp):
    """ShapeProp that also keeps each node's output metadata (a
    ``ShapeDtype``, a tuple of them, or, for a value that is no tensor,
    the value itself)."""

    def run_node(self, n):
        result = super().run_node(n)
        meta = _meta_of(result)
        n.meta["sbt_aval"] = meta
        n.meta["sbt_const"] = result if meta is None else None
        return result


class Tracer:
    """Captures a Graph of ``model`` on ``example_inputs``.

    ``skipped_modules`` (fnmatch patterns on the module path) mirrors the
    reference's SKIP_TRACE_MODULES: a matching module is one opaque node
    that runs its ``forward``."""

    def __init__(self, skipped_modules=None):
        self.skipped_patterns = list(skipped_modules or [])
        self.graph = None

    def trace(self, model, example_inputs):
        fx_graph = _FxTracer(self.skipped_patterns).trace(model)
        gm = torch.fx.GraphModule(model, fx_graph)
        # shapes from one forward in eval mode, so that no BatchNorm
        # updates its statistics and no Dropout draws
        modes = [(m, m.training) for m in model.modules()]
        model.eval()
        try:
            with torch.no_grad():
                _ValueProp(gm).propagate(*example_inputs)
        finally:
            for m, mode in modes:
                m.training = mode
        self.graph = _lower(gm, fx_graph)
        return self.graph


def _lower(gm, fx_graph):
    """fx graph -> Graph: every call becomes a node whose op is a Module."""
    graph = Graph()
    env = {}
    n_inputs = 0

    def mapped(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (tuple, list)):
            return type(a)(mapped(x) for x in a)
        if isinstance(a, dict):
            return {k: mapped(v) for k, v in a.items()}
        if isinstance(a, slice):
            return slice(mapped(a.start), mapped(a.stop), mapped(a.step))
        return a

    for fx_node in fx_graph.nodes:
        aval = fx_node.meta.get("sbt_aval")
        if fx_node.op == "placeholder":
            ph = graph.add_placeholder("input_{}".format(n_inputs))
            n_inputs += 1
            ph.out_aval = aval
            env[fx_node] = ph.symbolic()
        elif fx_node.op == "get_attr":
            # a tensor the model's forward reads directly: a constant, as
            # a captured array is in the JAX package's graph
            env[fx_node] = _fetch_attr(gm, fx_node.target)
        elif fx_node.op == "output":
            out = mapped(fx_node.args[0])
            out = list(out) if isinstance(out, (tuple, list)) else [out]
            assert all(isinstance(o, SymbolicTensor) for o in out), (
                "model output must be traced tensors")
            graph.set_output(out)
        elif aval is None:
            env[fx_node] = fx_node.meta["sbt_const"]  # shapes, sizes
        elif not _traced(mapped(list(fx_node.args))
                         + list(mapped(dict(fx_node.kwargs)).values())):
            env[fx_node] = _constant_call(gm, fx_node, mapped)
        elif fx_node.op == "call_module":
            op = gm.get_submodule(fx_node.target)
            if not isinstance(op, Module):
                raise TypeError(
                    "{} ({}) is not a module of sparsebit_tpu_torch.nn; the "
                    "graph regime traces only those".format(
                        fx_node.target, type(op).__name__))
            node = graph.create_node(op, mapped(list(fx_node.args)),
                                     mapped(dict(fx_node.kwargs)),
                                     name=fx_node.target, out_aval=aval)
            env[fx_node] = _symbolic_out(node)
        else:
            args = mapped(list(fx_node.args))
            kwargs = mapped(dict(fx_node.kwargs))
            if fx_node.target is operator.getitem and isinstance(
                    args[0], tuple):
                env[fx_node] = args[0][args[1]]  # an element of a split
                continue
            in_meta = [a for a in args if isinstance(a, SymbolicTensor)]
            lowered = F.lower_call(fx_node.target, args, kwargs, in_meta)
            if lowered is None:
                env[fx_node] = args[0]
                continue
            op, op_args, op_kwargs = lowered
            node = graph.create_node(op, op_args, op_kwargs, out_aval=aval)
            env[fx_node] = _symbolic_out(node)
    return graph


def _traced(values):
    """Whether a SymbolicTensor is among ``values`` (nested sequences
    too)."""
    for v in values:
        if isinstance(v, SymbolicTensor):
            return True
        if isinstance(v, (tuple, list)) and _traced(v):
            return True
    return False


def _constant_call(gm, fx_node, mapped):
    """The value of a call that reads no traced tensor, on its constant
    arguments."""
    args = mapped(list(fx_node.args))
    kwargs = mapped(dict(fx_node.kwargs))
    with torch.no_grad():
        if fx_node.op == "call_module":
            return gm.get_submodule(fx_node.target)(*args, **kwargs)
        if fx_node.op == "call_method":
            return getattr(args[0], fx_node.target)(*args[1:], **kwargs)
        return fx_node.target(*args, **kwargs)


def _symbolic_out(node):
    if isinstance(node.out_aval, tuple):
        return tuple(node.symbolic(i) for i in range(len(node.out_aval)))
    return node.symbolic()


def _fetch_attr(gm, target):
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj
