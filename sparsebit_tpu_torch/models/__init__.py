"""Model zoo built on ``sparsebit_tpu_torch.nn`` (port of
``sparsebit_tpu/models``): NHWC models that QuantModel traces whole. This
slice of the port holds the ResNets (resnet18/34/50, the cifar resnet20),
DeiT / ViT (deit_tiny/small/base) and BERT (bert_base, bert_tiny); the
rest of the JAX package's zoo is still to be ported."""

import torch

from sparsebit_tpu_torch import resolve_device

MODEL_REGISTRY = {}


def register_model(fn):
    MODEL_REGISTRY[fn.__name__] = fn
    return fn


def create_model(name, *, seed=0, device=None, **kwargs):
    """Model ``name`` with Kaiming-uniform weights drawn from a generator
    seeded with ``seed`` on ``device`` (the card unless the caller names
    another device), so the weights are made where the model runs."""
    assert name in MODEL_REGISTRY, "unknown model {} (have: {})".format(
        name, sorted(MODEL_REGISTRY))
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return MODEL_REGISTRY[name](generator=generator, device=device, **kwargs)


from sparsebit_tpu_torch.models import resnet, vit, bert  # noqa: E402,F401
from sparsebit_tpu_torch.models.resnet import (  # noqa: E402,F401
    resnet18,
    resnet20,
    resnet34,
    resnet50,
)
from sparsebit_tpu_torch.models.vit import (  # noqa: E402,F401
    deit_tiny,
    deit_small,
    deit_base,
)
from sparsebit_tpu_torch.models.bert import bert_base, bert_tiny  # noqa: E402,F401
