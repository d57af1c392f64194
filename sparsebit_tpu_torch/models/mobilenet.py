"""MobileNetV2, NHWC (port of ``sparsebit_tpu/models/mobilenet.py``; the
reference's PTQ basecase covers mobilenet_v2,
examples/post_training_quantization/imagenet1k/basecase/README.md:31).
Module paths are the JAX package's, so that one yaml selects the same
layers and ``nn.load_jax_state_dict`` carries its weights."""

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch.models import register_model


class ConvBNReLU(nn.Module):
    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1, *,
                 generator=None, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=(kernel - 1) // 2, groups=groups,
                              bias=False, generator=generator, device=device)
        self.bn = nn.BatchNorm2d(out_ch, device=device)
        self.act = nn.ReLU6()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    def __init__(self, in_ch, out_ch, stride, expand_ratio, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        hidden = int(round(in_ch * expand_ratio))
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(in_ch, hidden, kernel=1, **kw))
        layers.append(ConvBNReLU(hidden, hidden, stride=stride, groups=hidden,
                                 **kw))
        self.body = nn.Sequential(*layers)
        self.project = nn.Conv2d(hidden, out_ch, 1, bias=False, **kw)
        self.project_bn = nn.BatchNorm2d(out_ch, device=device)

    def forward(self, x):
        y = self.project_bn(self.project(self.body(x)))
        if self.use_res:
            y = x + y
        return y


class MobileNetV2(nn.Module):
    CFG = [
        # t, c, n, s
        (1, 16, 1, 1),
        (6, 24, 2, 2),
        (6, 32, 3, 2),
        (6, 64, 4, 2),
        (6, 96, 3, 1),
        (6, 160, 3, 2),
        (6, 320, 1, 1),
    ]

    def __init__(self, num_classes=1000, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.stem = ConvBNReLU(3, 32, stride=2, **kw)
        in_ch = 32
        blocks = []
        for t, c, n, s in self.CFG:
            for j in range(n):
                blocks.append(InvertedResidual(in_ch, c, s if j == 0 else 1, t,
                                               **kw))
                in_ch = c
        self.blocks = nn.Sequential(*blocks)
        self.head = ConvBNReLU(in_ch, 1280, kernel=1, **kw)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.flatten = nn.Flatten()
        self.classifier = nn.Linear(1280, num_classes, **kw)

    def forward(self, x):
        y = self.head(self.blocks(self.stem(x)))
        return self.classifier(self.flatten(self.avgpool(y)))


@register_model
def mobilenet_v2(num_classes=1000, *, generator=None, device=None):
    return MobileNetV2(num_classes, generator=generator, device=device)
