"""Model zoo built on ``sparsebit_tpu_torch.nn`` (port of
``sparsebit_tpu/models``): NHWC / NLC models that QuantModel and
SparseModel trace whole. The port holds the ResNets (resnet18/34/50, the
cifar resnet20), mobilenet_v2, efficientnet_lite0, regnetx_600mf, DeiT /
ViT (deit_tiny/small/base), BERT (bert_base, bert_tiny, and the
extractive-QA bert_qa, bert_qa_tiny), GPT-2 (gpt2_small, gpt2_tiny), the
YOLO family (yolov3_tiny, yolov3, yolov3_darknet21, yolov4, yolov4_small,
yolov5s, yolov5n) and BEVDet-lite (bevdet_lite), the whole of the JAX
package's zoo; ``import_torch`` fills them from torchvision, timm and
Hugging Face state dicts."""

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


from sparsebit_tpu_torch.models import (  # noqa: E402,F401
    resnet,
    mobilenet,
    efficientnet,
    regnet,
    vit,
    bert,
    gpt2,
    yolo,
    bevdet,
)
from sparsebit_tpu_torch.models.resnet import (  # noqa: E402,F401
    resnet18,
    resnet20,
    resnet34,
    resnet50,
)
from sparsebit_tpu_torch.models.mobilenet import mobilenet_v2  # noqa: E402,F401
from sparsebit_tpu_torch.models.efficientnet import (  # noqa: E402,F401
    efficientnet_lite0,
)
from sparsebit_tpu_torch.models.regnet import regnetx_600mf  # noqa: E402,F401
from sparsebit_tpu_torch.models.vit import (  # noqa: E402,F401
    deit_tiny,
    deit_small,
    deit_base,
)
from sparsebit_tpu_torch.models.bert import (  # noqa: E402,F401
    bert_base,
    bert_tiny,
    bert_qa,
    bert_qa_tiny,
)
from sparsebit_tpu_torch.models.gpt2 import gpt2_small, gpt2_tiny  # noqa: E402,F401
from sparsebit_tpu_torch.models.yolo import (  # noqa: E402,F401
    yolov3,
    yolov3_darknet21,
    yolov3_tiny,
    yolov4,
    yolov4_small,
    yolov5n,
    yolov5s,
)
from sparsebit_tpu_torch.models.bevdet import bevdet_lite  # noqa: E402,F401
