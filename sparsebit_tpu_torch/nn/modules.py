"""Module zoo of the graph regime (port of ``sparsebit_tpu/nn/modules.py``).

Every module is a ``torch.nn.Module`` with the JAX package's name and
constructor arguments. Leaf modules compute in ``execute(*args,
params=None, training=False)``, which takes replacements for their state
(``params``, a ``{name: tensor}`` dict) so that a QModule can hand down a
fake-quantized weight, and ``forward`` calls it; containers define
``forward`` only and are traced through (``nn/graph.py``).

Layouts. Activations stay in the JAX package's: NHWC for CNNs, NLC for
sequences, because ``A.OBSERVER.LAYOUT`` (default NHWC) decides the
activation channel axis. Weights take PyTorch's: conv OIHW, transposed
conv (in, out // groups, kh, kw), linear (out, in), so the out-channel
axis of a conv or linear weight is 0 (the JAX package's HWIO and (in,
out) put it at 3 and 1). A conv computes ``F.conv2d`` on the NHWC tensor
viewed as NCHW, which is ``channels_last`` to cuDNN, so no copy is made.
``load_jax_state_dict`` fills a port model from the JAX model's
``full_state_dict()`` as numpy arrays, transposing the weights.

Initial weights are Kaiming-uniform from an explicit ``torch.Generator``
(``generator``, on ``device``); BatchNorm follows the JAX package's math,
not ``torch.nn.BatchNorm2d``'s: the training update of ``running_var``
takes the biased variance, and evaluation is ``(x - mean) * rsqrt(var +
eps) * weight + bias``.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from sparsebit_tpu_torch.quantization.common import div_exact


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


def _uniform(shape, bound, generator, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-bound, bound, generator=generator)


def _kaiming_uniform(shape, fan_in, generator, device):
    bound = math.sqrt(1.0 / fan_in) if fan_in > 0 else 0.0
    return torch.nn.Parameter(_uniform(shape, bound, generator, device))


def _nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def _nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1)


class Module(torch.nn.Module):
    """Base module. Leaf ops override ``execute``; containers override
    ``forward``. A skipped container (``SKIP_TRACE_MODULES``) becomes one
    graph node and runs its ``forward`` through the default ``execute``."""

    def execute(self, *args, params=None, training=False, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        if type(self).execute is Module.execute:
            raise NotImplementedError(
                "{} defines neither execute nor forward".format(
                    type(self).__name__))
        return self.execute(*args, training=self.training, **kwargs)

    def is_leaf(self):
        return type(self).execute is not Module.execute

    def get(self, params, name):
        """A state tensor, preferring the replacement in ``params``."""
        if params is not None and name in params:
            return params[name]
        return getattr(self, name)

    # ---- leaf state: this module's parameters and buffers ----------------
    def leaf_state_dict(self):
        """{name: tensor} of THIS module's parameters and buffers (not its
        children's), the JAX package's ``Module.state_dict``."""
        out = {}
        for k, v in self._parameters.items():
            if v is not None:
                out[k] = v
        for k, v in self._buffers.items():
            if v is not None:
                out[k] = v
        return out

    def load_leaf_state_dict(self, sd):
        with torch.no_grad():
            for k, v in sd.items():
                if k in self._parameters:
                    cur = self._parameters[k]
                    v = torch.as_tensor(v)
                    if cur is None:
                        self._parameters[k] = torch.nn.Parameter(
                            v.to(torch.float32))
                    elif v is not cur:
                        cur.data = v.to(device=cur.device,
                                        dtype=cur.dtype).clone()
                elif k in self._buffers:
                    cur = self._buffers[k]
                    v = torch.as_tensor(v)
                    self._buffers[k] = v.to(
                        device=cur.device if cur is not None else v.device
                    ).clone()


class Sequential(Module):
    def __init__(self, *mods):
        super().__init__()
        for i, m in enumerate(mods):
            self.add_module(str(i), m)

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


class ModuleList(Module):
    def __init__(self, mods=()):
        super().__init__()
        for i, m in enumerate(mods):
            self.add_module(str(i), m)

    def append(self, m):
        self.add_module(str(len(self._modules)), m)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


# ---- compute leaves ---------------------------------------------------------


class Conv2d(Module):
    """NHWC conv, OIHW weight (JAX package: HWIO)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, *,
                 generator=None, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        kh, kw = self.kernel_size
        fan_in = in_channels // groups * kh * kw
        self.weight = _kaiming_uniform(
            (out_channels, in_channels // groups, kh, kw), fan_in, generator,
            device)
        self.bias = (_kaiming_uniform((out_channels,), fan_in, generator,
                                      device) if bias else None)

    def execute(self, x, params=None, training=False):
        b = self.get(params, "bias") if self.bias is not None else None
        out = F.conv2d(_nhwc_to_nchw(x), self.get(params, "weight"), b,
                       self.stride, self.padding, self.dilation, self.groups)
        return _nchw_to_nhwc(out)


class ConvTranspose2d(Module):
    """NHWC transposed conv, weight (in, out // groups, kh, kw) (JAX
    package: (kh, kw, out // groups, in))."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, bias=True,
                 dilation=1, *, generator=None, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.output_padding = _pair(output_padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        kh, kw = self.kernel_size
        fan_in = out_channels // groups * kh * kw
        self.weight = _kaiming_uniform(
            (in_channels, out_channels // groups, kh, kw), fan_in, generator,
            device)
        self.bias = (_kaiming_uniform((out_channels,), fan_in, generator,
                                      device) if bias else None)

    def execute(self, x, params=None, training=False):
        b = self.get(params, "bias") if self.bias is not None else None
        out = F.conv_transpose2d(
            _nhwc_to_nchw(x), self.get(params, "weight"), b, self.stride,
            self.padding, self.output_padding, self.groups, self.dilation)
        return _nchw_to_nhwc(out)


class Linear(Module):
    """(out, in) weight (JAX package: (in, out))."""

    def __init__(self, in_features, out_features, bias=True, *,
                 generator=None, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _kaiming_uniform((out_features, in_features),
                                       in_features, generator, device)
        self.bias = (_kaiming_uniform((out_features,), in_features,
                                      generator, device) if bias else None)

    def execute(self, x, params=None, training=False):
        b = self.get(params, "bias") if self.bias is not None else None
        return F.linear(x, self.get(params, "weight"), b)


class Embedding(Module):
    def __init__(self, num_embeddings, embedding_dim, *, generator=None,
                 device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        w = torch.empty((num_embeddings, embedding_dim), device=device)
        self.weight = torch.nn.Parameter(
            w.normal_(generator=generator) * 0.02)

    def execute(self, x, params=None, training=False):
        return F.embedding(x, self.get(params, "weight"))


class _SumOverGroup(torch.autograd.Function):
    """all_reduce sum whose gradient is summed too: the sum feeds each
    rank's own normalisation, so every rank's loss reaches every rank's
    summand."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, gy):
        gx = gy.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(gx, group=ctx.group)
        return gx, None


@contextlib.contextmanager
def data_parallel(group, *models):
    """For the block, the BatchNorms and quantizers of ``models`` (a
    QuantModel or SparseModel by its graph's ops, or a module) train on
    this rank's rows of a batch that the ranks of ``group``, a
    data-parallel group, split in equal shares. The JAX package's jitted
    step over a batch sharded on "dp" sees the global batch; so here
    BatchNorm takes its training statistics over the global batch and
    LSQ's gradient scale counts the global batch's elements. Each object
    that reads the group holds it as ``dp_group``, None outside the
    block; ``group`` None changes nothing."""
    held = []
    for model in models if group is not None else ():
        graph = getattr(model, "graph", None)
        for op in ([n.op for n in graph.op_nodes] if graph is not None
                   else [model]):
            for m in (op.modules() if isinstance(op, torch.nn.Module)
                      else [op]):
                held += [o for o in (m, *vars(m).values())
                         if hasattr(o, "dp_group")]
    for o in held:
        o.dp_group = group
    try:
        yield
    finally:
        for o in held:
            o.dp_group = None


def _group_moments(x, dims, group):
    """Mean and biased variance over ``dims`` of the batch whose rows the
    ranks of ``group`` split between them (equal shares), in two passes,
    differentiably."""
    ch = next(i for i in range(x.dim()) if i not in dims)
    n = x.numel() // x.shape[ch] * torch.distributed.get_world_size(group)
    mean = _SumOverGroup.apply(x.sum(dim=dims), group) / n
    d = x - mean.reshape([-1 if i == ch else 1 for i in range(x.dim())])
    return mean, _SumOverGroup.apply((d * d).sum(dim=dims), group) / n


class BatchNorm2d(Module):
    """Batch norm over the last (channel) axis, the JAX package's math.
    In training its statistics are the rank's batch's, or the global
    batch's within ``data_parallel``."""

    CH_AXIS = -1
    dp_group = None  # set by data_parallel

    def __init__(self, num_features, eps=1e-5, momentum=0.1, *,
                 device=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = torch.nn.Parameter(torch.ones(num_features,
                                                    device=device))
        self.bias = torch.nn.Parameter(torch.zeros(num_features,
                                                   device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def _stats_dims(self, x):
        ch = (x.dim() + self.CH_AXIS) % x.dim()
        return tuple(i for i in range(x.dim()) if i != ch)

    def execute(self, x, params=None, training=False):
        gamma = self.get(params, "weight")
        beta = self.get(params, "bias")
        if training:
            dims = self._stats_dims(x)
            if self.dp_group is None:
                mean = x.mean(dim=dims)
                var = x.var(dim=dims, unbiased=False)  # jnp.var: biased
            else:
                mean, var = _group_moments(x, dims, self.dp_group)
            with torch.no_grad():  # in place: the tensors stay the state
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var)
        else:
            mean = self.get(params, "running_mean")
            var = self.get(params, "running_var")
        return (x - mean) * torch.rsqrt(var + self.eps) * gamma + beta


class BatchNorm1d(BatchNorm2d):
    pass


class LayerNorm(Module):
    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.weight = torch.nn.Parameter(
                torch.ones(self.normalized_shape, device=device))
            self.bias = torch.nn.Parameter(
                torch.zeros(self.normalized_shape, device=device))

    def execute(self, x, params=None, training=False):
        dims = tuple(range(x.dim() - len(self.normalized_shape), x.dim()))
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, unbiased=False, keepdim=True)
        out = (x - mean) * torch.rsqrt(var + self.eps)
        if self.elementwise_affine:
            out = out * self.get(params, "weight") + self.get(params, "bias")
        return out


class RMSNorm(Module):
    def __init__(self, dim, eps=1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(dim, device=device))

    def execute(self, x, params=None, training=False):
        var = x.float().square().mean(dim=-1, keepdim=True)
        out = x * torch.rsqrt(var + self.eps)
        return (out * self.get(params, "weight")).to(x.dtype)


# ---- activations ------------------------------------------------------------


class _Activation(Module):
    def execute(self, x, params=None, training=False):
        return self.fn(x)


class ReLU(_Activation):
    fn = staticmethod(torch.relu)


class ReLU6(_Activation):
    fn = staticmethod(lambda x: torch.clamp(x, 0.0, 6.0))


class LeakyReLU(Module):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def execute(self, x, params=None, training=False):
        return F.leaky_relu(x, self.negative_slope)


class Sigmoid(_Activation):
    fn = staticmethod(torch.sigmoid)


class SiLU(_Activation):
    fn = staticmethod(F.silu)


class GELU(Module):
    """``approximate="tanh"`` by default, as ``jax.nn.gelu``."""

    def __init__(self, approximate="tanh"):
        super().__init__()
        self.approximate = approximate

    def execute(self, x, params=None, training=False):
        return F.gelu(x, approximate=self.approximate)


class Mish(_Activation):
    fn = staticmethod(lambda x: x * torch.tanh(F.softplus(x)))


class Hardsigmoid(_Activation):
    fn = staticmethod(F.hardsigmoid)


class Tanh(_Activation):
    fn = staticmethod(torch.tanh)


class Softmax(Module):
    def __init__(self, dim=-1):
        super().__init__()
        self.dim = dim

    def execute(self, x, params=None, training=False):
        return torch.softmax(x, dim=self.dim)


# ---- pooling (NHWC) ---------------------------------------------------------


class MaxPool2d(Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        self.padding = _pair(padding)

    def execute(self, x, params=None, training=False):
        out = F.max_pool2d(_nhwc_to_nchw(x), self.kernel_size, self.stride,
                           self.padding)
        return _nchw_to_nhwc(out)


class AvgPool2d(Module):
    """Zero padding counted in the mean, as the JAX package's sum over the
    padded window divided by kh * kw."""

    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        self.padding = _pair(padding)

    def execute(self, x, params=None, training=False):
        out = F.avg_pool2d(_nhwc_to_nchw(x), self.kernel_size, self.stride,
                           self.padding, count_include_pad=True)
        return _nchw_to_nhwc(out)


class AdaptiveAvgPool2d(Module):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = _pair(output_size)

    def execute(self, x, params=None, training=False):
        oh, ow = self.output_size
        n, h, w, c = x.shape
        assert h % oh == 0 and w % ow == 0, (
            "AdaptiveAvgPool2d requires divisible sizes, got {}x{} -> {}x{}"
            .format(h, w, oh, ow))
        kh, kw = h // oh, w // ow
        return x.reshape(n, oh, kh, ow, kw, c).mean(dim=(2, 4))


# ---- misc leaves ------------------------------------------------------------


class Identity(Module):
    def execute(self, x, params=None, training=False):
        return x


class Dropout(Module):
    """Identity at inference; in training it drops with a mask drawn from
    the explicit ``torch.Generator`` in ``params["generator"]`` (without
    one it stays the identity, as the JAX package's does without an
    ``rng_key``)."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def execute(self, x, params=None, training=False):
        g = (params or {}).get("generator")
        if not training or self.p == 0.0 or g is None:
            return x
        keep = 1.0 - self.p
        mask = (torch.rand(x.shape, generator=g, device=g.device)
                < keep).to(x.device)
        return torch.where(mask, div_exact(x, keep), torch.zeros_like(x))


class Flatten(Module):
    def __init__(self, start_dim=1, end_dim=-1):
        super().__init__()
        self.start_dim = start_dim
        self.end_dim = end_dim

    def execute(self, x, params=None, training=False):
        start = self.start_dim % x.dim()
        end = self.end_dim % x.dim()
        return x.reshape(tuple(x.shape[:start]) + (-1,)
                         + tuple(x.shape[end + 1:]))


def resize_nhwc(x, size, mode):
    """NHWC resize with half-pixel centres, ``jax.image.resize``'s
    convention ("nearest" is PyTorch's "nearest-exact")."""
    torch_mode = {"nearest": "nearest-exact", "bilinear": "bilinear"}[mode]
    kw = {} if mode == "nearest" else {"align_corners": False}
    out = F.interpolate(_nhwc_to_nchw(x), size=tuple(size), mode=torch_mode,
                        **kw)
    return _nchw_to_nhwc(out)


class Upsample(Module):
    def __init__(self, scale_factor=2, mode="nearest"):
        super().__init__()
        self.scale_factor = _pair(scale_factor)
        self.mode = mode

    def execute(self, x, params=None, training=False):
        n, h, w, c = x.shape
        sh, sw = self.scale_factor
        return resize_nhwc(x, (int(h * sh), int(w * sw)), self.mode)


# ---- weights from the JAX package -------------------------------------------

_TO_TORCH_LAYOUT = {
    # (module class, state name): permutation of the JAX array's axes
    (Conv2d, "weight"): (3, 2, 0, 1),  # HWIO -> OIHW
    (ConvTranspose2d, "weight"): (3, 2, 0, 1),  # (kh, kw, o/g, i) -> (i, o/g, kh, kw)
    (Linear, "weight"): (1, 0),  # (in, out) -> (out, in)
}


def load_jax_state_dict(model, state):
    """Fill ``model`` from the JAX package's ``full_state_dict()`` of the
    same architecture, given as numpy arrays (``{"layer1.0.conv1.weight":
    array, ...}``), transposing conv and linear weights to PyTorch's
    layouts. Every parameter and buffer of the model must be in
    ``state``; the tensors keep their device."""
    missing = []
    for path, m in model.named_modules():
        local = {}
        for k in list(m._parameters) + list(m._buffers):
            if m._parameters.get(k, m._buffers.get(k)) is None:
                continue
            full = "{}.{}".format(path, k) if path else k
            if full not in state:
                missing.append(full)
                continue
            v = np.asarray(state[full])
            perm = next((p for (cls, name), p in _TO_TORCH_LAYOUT.items()
                         if isinstance(m, cls) and name == k), None)
            if perm is not None:
                v = np.transpose(v, perm)
            local[k] = torch.tensor(v)
        if local:
            m.load_leaf_state_dict(local)
    if missing:
        raise KeyError("state lacks {}".format(missing))
    return model
