"""Functional op-modules and the table that lowers ``torch.fx`` targets onto
them (port of ``sparsebit_tpu/nn/functional.py``).

Every functional operation (``x + y``, ``torch.matmul``, ``x.view``,
``F.relu``, ...) becomes a graph node whose op is one of these
parameter-free modules, so QModule conversion, the matcher and
calibration see one uniform graph, as in the JAX package. ``torch.fx``
records Python operators itself, so the JAX package's operator overloads
on its symbolic tensor have no counterpart here; ``FX_TARGETS`` and
``lower_call`` (used by ``nn/graph.py``) map each recorded target and its
arguments onto an op-module and its keyword arguments.

The helper functions at the end (``add``, ``reshape``, ``interpolate``,
...) mirror the JAX package's dual-mode helpers: they compute eagerly on
tensors and are recorded as one node each under tracing
(``torch.fx.wrap``).
"""

import operator

import torch
import torch.fx
import torch.nn.functional as TF

from sparsebit_tpu_torch.quantization.common import div_exact
from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.nn.modules import Module


class Add(Module):
    def execute(self, x, y, params=None, training=False):
        return x + y


class Subtract(Module):
    def execute(self, x, y, params=None, training=False):
        return x - y


class Mul(Module):
    def execute(self, x, y, params=None, training=False):
        return x * y


class Divide(Module):
    """A divide by a plain number goes through ``div_exact``, so that the
    card rounds it as the CPU does."""

    def execute(self, x, y, params=None, training=False):
        if isinstance(x, torch.Tensor) and isinstance(y, (int, float)):
            return div_exact(x, float(y))
        return x / y


class FloorDiv(Module):
    def execute(self, x, y, params=None, training=False):
        return x // y


class Pow(Module):
    def execute(self, x, y, params=None, training=False):
        return x ** y


class Negative(Module):
    def execute(self, x, params=None, training=False):
        return -x


class MatMul(Module):
    def execute(self, x, y, params=None, training=False):
        return torch.matmul(x, y)


class Mean(Module):
    def execute(self, x, params=None, training=False, axis=None,
                keepdims=False):
        if axis is None:
            return x.mean()
        return x.mean(dim=axis, keepdim=keepdims)


class Reshape(Module):
    def execute(self, x, params=None, training=False, shape=None):
        return x.reshape(shape)


class Transpose(Module):
    def execute(self, x, params=None, training=False, dim0=0, dim1=1):
        return x.transpose(dim0, dim1)


class Permute(Module):
    def execute(self, x, params=None, training=False, dims=None):
        return x.permute(dims)


class Concat(Module):
    def execute(self, *xs, params=None, training=False, axis=0):
        return torch.cat(xs, dim=axis)


class Split(Module):
    def execute(self, x, params=None, training=False, size=None, axis=0):
        return tuple(torch.split(x, size, dim=axis))


class Expand(Module):
    def execute(self, x, params=None, training=False, shape=None):
        return x.expand(shape)


class GetItem(Module):
    def execute(self, x, params=None, training=False, idx=None):
        return x[idx]


class Where(Module):
    def execute(self, cond, x, y, params=None, training=False):
        return torch.where(cond, x, y)


class Detach(Module):
    def execute(self, x, params=None, training=False):
        return x.detach()


class Cast(Module):
    def execute(self, x, params=None, training=False, dtype=None):
        return x.to(dtype)


class StochasticDepth(Module):
    """torchvision.ops.StochasticDepth analogue; the mask comes from an
    explicit ``torch.Generator`` (``params["generator"]``)."""

    def __init__(self, p=0.0, mode="row"):
        super().__init__()
        self.p = p
        self.mode = mode

    def execute(self, x, params=None, training=False):
        g = (params or {}).get("generator")
        if not training or self.p == 0.0 or g is None:
            return x
        keep = 1.0 - self.p
        shape = ((x.shape[0],) + (1,) * (x.dim() - 1)
                 if self.mode == "row" else ())
        mask = (torch.rand(shape, generator=g, device=g.device)
                < keep).to(x.device)
        return torch.where(mask, div_exact(x, keep), torch.zeros_like(x))


class Interpolate(Module):
    """NHWC resize (``F.interpolate`` analogue on the JAX package's
    layout)."""

    def execute(self, x, params=None, training=False, size=None,
                scale_factor=None, mode="nearest"):
        n, h, w, c = x.shape
        if size is not None:
            oh, ow = size if isinstance(size, (tuple, list)) else (size, size)
        else:
            sf = (scale_factor if isinstance(scale_factor, (tuple, list))
                  else (scale_factor, scale_factor))
            oh, ow = int(h * sf[0]), int(w * sf[1])
        return nn.resize_nhwc(x, (oh, ow), mode)


# ---- helpers (eager on tensors, one node each under tracing) ----------------


@torch.fx.wrap
def add(x, y):
    return Add().execute(x, y)


@torch.fx.wrap
def subtract(x, y):
    return Subtract().execute(x, y)


@torch.fx.wrap
def mul(x, y):
    return Mul().execute(x, y)


@torch.fx.wrap
def divide(x, y):
    return Divide().execute(x, y)


@torch.fx.wrap
def matmul(x, y):
    return MatMul().execute(x, y)


@torch.fx.wrap
def concat(xs, axis=0):
    return Concat().execute(*xs, axis=axis)


@torch.fx.wrap
def where(cond, x, y):
    return Where().execute(cond, x, y)


@torch.fx.wrap
def split(x, size, axis=0):
    return Split().execute(x, size=size, axis=axis)


@torch.fx.wrap
def mean(x, axis=None, keepdims=False):
    return Mean().execute(x, axis=axis, keepdims=keepdims)


@torch.fx.wrap
def interpolate(x, size=None, scale_factor=None, mode="nearest"):
    return Interpolate().execute(x, size=size, scale_factor=scale_factor,
                                 mode=mode)


@torch.fx.wrap
def softmax(x, axis=-1):
    return nn.Softmax(dim=axis).execute(x)


@torch.fx.wrap
def relu(x):
    return nn.ReLU().execute(x)


@torch.fx.wrap
def gelu(x):
    return nn.GELU().execute(x)


@torch.fx.wrap
def detach(x):
    return Detach().execute(x)


@torch.fx.wrap
def reshape(x, shape):
    return Reshape().execute(x, shape=tuple(shape))


@torch.fx.wrap
def transpose(x, dim0, dim1):
    return Transpose().execute(x, dim0=dim0, dim1=dim1)


@torch.fx.wrap
def permute(x, dims):
    return Permute().execute(x, dims=tuple(dims))


@torch.fx.wrap
def expand(x, shape):
    return Expand().execute(x, shape=tuple(shape))


@torch.fx.wrap
def getitem(x, idx):
    return GetItem().execute(x, idx=idx)


@torch.fx.wrap
def cast(x, dtype):
    return Cast().execute(x, dtype=dtype)


# ---- lowering of fx targets -------------------------------------------------


def _binary(cls):
    return lambda args, kw, meta: (cls(), list(args[:2]), {})


def _unary(cls):
    return lambda args, kw, meta: (cls(), [args[0]], {})


def _shape_arg(args, kw, key="shape"):
    rest = args[1:]
    if key in kw:
        return tuple(kw[key])
    if len(rest) == 1 and isinstance(rest[0], (tuple, list, torch.Size)):
        return tuple(rest[0])
    return tuple(rest)


def _reshape(args, kw, meta):
    return Reshape(), [args[0]], {"shape": _shape_arg(args, kw)}


def _permute(args, kw, meta):
    return Permute(), [args[0]], {"dims": _shape_arg(args, kw, "dims")}


def _expand(args, kw, meta):
    return Expand(), [args[0]], {"shape": _shape_arg(args, kw, "size")}


def _transpose(args, kw, meta):
    d0 = args[1] if len(args) > 1 else kw["dim0"]
    d1 = args[2] if len(args) > 2 else kw["dim1"]
    return Transpose(), [args[0]], {"dim0": d0, "dim1": d1}


def _flatten(args, kw, meta):
    """``torch.flatten`` / ``Tensor.flatten`` as a Reshape to the shape the
    JAX package's ``flatten`` overload computes."""
    start = args[1] if len(args) > 1 else kw.get("start_dim", 0)
    end = args[2] if len(args) > 2 else kw.get("end_dim", -1)
    shape = tuple(meta[0].shape)
    nd = len(shape)
    return Reshape(), [args[0]], {
        "shape": shape[:start % nd] + (-1,) + shape[end % nd + 1:]}


def _mean(args, kw, meta):
    axis = args[1] if len(args) > 1 else kw.get("dim", kw.get("axis"))
    keep = args[2] if len(args) > 2 else kw.get("keepdim",
                                                 kw.get("keepdims", False))
    if isinstance(axis, list):
        axis = tuple(axis)
    return Mean(), [args[0]], {"axis": axis, "keepdims": keep}


def _cat(args, kw, meta):
    xs = args[0]
    axis = args[1] if len(args) > 1 else kw.get("dim", kw.get("axis", 0))
    return Concat(), list(xs), {"axis": axis}


def _split(args, kw, meta):
    size = args[1] if len(args) > 1 else kw.get("split_size_or_sections",
                                                kw.get("size"))
    axis = args[2] if len(args) > 2 else kw.get("dim", kw.get("axis", 0))
    return Split(), [args[0]], {"size": size, "axis": axis}


def _getitem(args, kw, meta):
    return GetItem(), [args[0]], {"idx": args[1]}


def _softmax(args, kw, meta):
    dim = args[1] if len(args) > 1 else kw.get("dim", kw.get("axis", -1))
    return nn.Softmax(dim=dim), [args[0]], {}


def _leaky_relu(args, kw, meta):
    slope = args[1] if len(args) > 1 else kw.get("negative_slope", 0.01)
    return nn.LeakyReLU(slope), [args[0]], {}


def _gelu(args, kw, meta):
    return nn.GELU(kw.get("approximate", "none")), [args[0]], {}


def _to(args, kw, meta):
    dtype = kw.get("dtype")
    for a in args[1:]:
        if isinstance(a, torch.dtype):
            dtype = a
    if dtype is None:
        raise NotImplementedError("Tensor.to without a dtype")
    return Cast(), [args[0]], {"dtype": dtype}


def _helper_cat(args, kw, meta):
    return Concat(), list(args[0]), {
        "axis": args[1] if len(args) > 1 else kw.get("axis", 0)}


def _helper_softmax(args, kw, meta):
    return nn.Softmax(dim=args[1] if len(args) > 1 else kw.get("axis", -1)
                      ), [args[0]], {}


def _kw_after(cls, names):
    def lower(args, kw, meta):
        kwargs = dict(zip(names, args[1:]))
        kwargs.update(kw)
        for k in ("shape", "dims"):
            if k in kwargs:
                kwargs[k] = tuple(kwargs[k])
        return cls(), [args[0]], kwargs
    return lower


# target (a function, or a Tensor method's name) -> lowering
FX_TARGETS = {
    operator.add: _binary(Add), torch.add: _binary(Add), "add": _binary(Add),
    operator.sub: _binary(Subtract), torch.sub: _binary(Subtract),
    "sub": _binary(Subtract),
    operator.mul: _binary(Mul), torch.mul: _binary(Mul), "mul": _binary(Mul),
    operator.truediv: _binary(Divide), torch.div: _binary(Divide),
    "div": _binary(Divide),
    operator.floordiv: _binary(FloorDiv),
    operator.pow: _binary(Pow), torch.pow: _binary(Pow), "pow": _binary(Pow),
    operator.neg: _unary(Negative), torch.neg: _unary(Negative),
    "neg": _unary(Negative),
    operator.matmul: _binary(MatMul), torch.matmul: _binary(MatMul),
    torch.bmm: _binary(MatMul), "matmul": _binary(MatMul),
    torch.mean: _mean, "mean": _mean,
    torch.reshape: _reshape, "reshape": _reshape, "view": _reshape,
    torch.flatten: _flatten, "flatten": _flatten,
    torch.permute: _permute, "permute": _permute,
    torch.transpose: _transpose, "transpose": _transpose,
    "expand": _expand,
    torch.cat: _cat, torch.concat: _cat,
    torch.split: _split, "split": _split,
    operator.getitem: _getitem,
    torch.where: lambda args, kw, meta: (Where(), list(args[:3]), {}),
    "detach": _unary(Detach), torch.detach: _unary(Detach),
    "to": _to,
    "contiguous": None,  # no op on the graph: the input passes through
    TF.relu: _unary(nn.ReLU), torch.relu: _unary(nn.ReLU),
    "relu": _unary(nn.ReLU),
    TF.relu6: _unary(nn.ReLU6),
    TF.leaky_relu: _leaky_relu,
    torch.sigmoid: _unary(nn.Sigmoid), TF.sigmoid: _unary(nn.Sigmoid),
    "sigmoid": _unary(nn.Sigmoid),
    TF.silu: _unary(nn.SiLU),
    TF.gelu: _gelu,
    TF.mish: _unary(nn.Mish),
    TF.hardsigmoid: _unary(nn.Hardsigmoid),
    torch.tanh: _unary(nn.Tanh), TF.tanh: _unary(nn.Tanh),
    "tanh": _unary(nn.Tanh),
    torch.softmax: _softmax, TF.softmax: _softmax, "softmax": _softmax,
    # the port's helpers
    add: _binary(Add), subtract: _binary(Subtract), mul: _binary(Mul),
    divide: _binary(Divide), matmul: _binary(MatMul),
    concat: _helper_cat,
    where: lambda args, kw, meta: (Where(), list(args[:3]), {}),
    split: _kw_after(Split, ("size", "axis")),
    mean: _kw_after(Mean, ("axis", "keepdims")),
    interpolate: _kw_after(Interpolate, ("size", "scale_factor", "mode")),
    softmax: _helper_softmax,
    relu: _unary(nn.ReLU), gelu: lambda args, kw, meta: (
        nn.GELU(), [args[0]], {}),
    detach: _unary(Detach),
    reshape: _kw_after(Reshape, ("shape",)),
    transpose: _kw_after(Transpose, ("dim0", "dim1")),
    permute: _kw_after(Permute, ("dims",)),
    expand: _kw_after(Expand, ("shape",)),
    getitem: _kw_after(GetItem, ("idx",)),
    cast: _kw_after(Cast, ("dtype",)),
}


def lower_call(target, args, kwargs, in_meta):
    """(op-module, tensor-or-constant args, keyword args) for one fx
    ``call_function`` / ``call_method`` node; ``None`` for a target that
    passes its input through. ``in_meta``: the metadata of the node's
    tensor inputs (shape, dtype), in order."""
    if target not in FX_TARGETS:
        raise NotImplementedError(
            "the graph tracer has no op-module for {!r}".format(target))
    lower = FX_TARGETS[target]
    if lower is None:
        return None
    return lower(args, kwargs, in_meta)
