"""QAT training utilities (port of
``sparsebit_tpu/quantization/tools/qat.py``; the reference trains QAT
models with a plain torch loop over QuantModel,
examples/quantization_aware_training/.../main.py: fake-quant forward, STE
backward, an optimiser step).

The trainable state is ``QuantModel.trainable_params()``,
``{node: {name: tensor}}``: the wrapped modules' weights and the enabled
quantizers' learnables (LSQ scales, LSQ+ zero points, PACT's alpha). Its
tensors are the ones the graph reads, so a ``torch.optim`` optimiser
built over them (``init_qat_state``) trains the model in place. A torch
optimiser holds its own state, so the JAX package's ``opt_state`` has no
counterpart: ``make_qat_step``'s step takes and returns the trainable
dict and the loss. ``optax.adam`` and ``torch.optim.Adam`` put ``eps``
at the same place (outside the square root), so one step from the same
state agrees.

Buffers among the trainable state (BatchNorm's running statistics) take
no gradient. In training mode BatchNorm normalises with the batch's
statistics and updates its running ones in place, as the reference's
train mode does (the JAX package's jitted step leaves them).
"""

import torch
import torch.nn.functional as TF

from sparsebit_tpu_torch.nn.modules import data_parallel
from sparsebit_tpu_torch.parallel.mesh import sum_grads


def merge_params(base, trainable):
    """Overlay the trainable dict onto the full params dict."""
    merged = {n: dict(p) for n, p in base.items()}
    for n, p in trainable.items():
        merged.setdefault(n, {}).update(p)
    return merged


def qat_parameters(trainable):
    """The tensors of ``trainable`` that take a gradient, in node order:
    what the optimiser trains."""
    return [v for p in trainable.values() for v in p.values()
            if isinstance(v, torch.Tensor) and v.requires_grad]


def init_qat_state(qmodel, make_optimizer):
    """(trainable, optimizer): ``qmodel.trainable_params()`` and
    ``make_optimizer(qat_parameters(trainable))``, for example
    ``lambda ps: torch.optim.Adam(ps, lr=1e-4)``. The QuantModel must be
    through ``init_QAT()``, so that the quantizers' learnables are among
    the trainables."""
    trainable = qmodel.trainable_params()
    return trainable, make_optimizer(qat_parameters(trainable))


def make_qat_step(qmodel, loss_fn, optimizer, mesh=None):
    """A step ``(trainable, *batch) -> (trainable, loss)``: the forward
    ``qmodel.apply(params, batch[0], training=True)`` over the trainables
    merged into the model's params, ``loss_fn(outputs, *batch[1:])``, its
    backward and ``optimizer.step()``, which updates the trainables in
    place. With a ``mesh`` that has a "dp" axis, the batch is this rank's
    rows of the global batch: the forward runs within
    ``nn.data_parallel`` of the dp group and the gradients are averaged
    over dp before the optimiser's step."""
    base = qmodel.params()
    group = None if mesh is None else mesh.get_group("dp")

    def step(trainable, *batch):
        optimizer.zero_grad(set_to_none=True)
        with data_parallel(group, qmodel):
            out = qmodel.apply(merge_params(base, trainable), batch[0],
                               training=True)
        loss = loss_fn(out, *batch[1:])
        loss.backward()
        if mesh is not None:
            sum_grads(trainable, mesh, ("dp",), mean=True)
        optimizer.step()
        return trainable, loss.detach()

    return step


@torch.no_grad()
def commit_qat_params(qmodel, trainable):
    """Write trained values back into the model's state (after training;
    numpy arrays or tensors). A value is copied into the tensor the model
    holds under its name, so a quantizer's learnable stays a leaf that
    takes a gradient; the model's own tensors are left as they are."""
    for name, p in trainable.items():
        op = qmodel.get_qmodule(name)
        current = op.trainable_params()
        rest = {}
        for k, v in p.items():
            cur = current.get(k)
            if cur is None:
                rest[k] = v
            elif v is not cur:
                cur.copy_(torch.as_tensor(v).to(device=cur.device,
                                                dtype=cur.dtype))
        if rest:
            op.load_leaf_state_dict(rest)


def cross_entropy(logits, labels):
    """Mean negative log-likelihood of ``labels`` (integers)."""
    return TF.cross_entropy(logits, labels.long())
