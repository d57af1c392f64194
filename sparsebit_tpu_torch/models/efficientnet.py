"""EfficientNet-Lite0, NHWC (port of
``sparsebit_tpu/models/efficientnet.py``; the reference's PTQ/QAT README
tables include it, examples/post_training_quantization/imagenet1k/
basecase/README.md:27-33). The Lite variants drop squeeze-excite and
take ReLU6 for SiLU, so the blocks are Conv2d / BatchNorm2d / ReLU6
only. Module paths are the JAX package's."""

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch.models import register_model


class ConvBNAct(nn.Module):
    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1, act=True,
                 *, generator=None, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=(kernel - 1) // 2, groups=groups,
                              bias=False, generator=generator, device=device)
        self.bn = nn.BatchNorm2d(out_ch, device=device)
        self.act = nn.ReLU6() if act else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class MBConvLite(nn.Module):
    """MBConv without squeeze-excite: expand 1x1 -> depthwise kxk ->
    project 1x1, residual when the stride is 1 and the channels match."""

    def __init__(self, in_ch, out_ch, kernel, stride, expand, *,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        hidden = in_ch * expand
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if expand != 1:
            layers.append(ConvBNAct(in_ch, hidden, kernel=1, **kw))
        layers.append(ConvBNAct(hidden, hidden, kernel=kernel, stride=stride,
                                groups=hidden, **kw))
        layers.append(ConvBNAct(hidden, out_ch, kernel=1, act=False, **kw))
        self.body = nn.Sequential(*layers)

    def forward(self, x):
        y = self.body(x)
        if self.use_res:
            y = x + y
        return y


class EfficientNetLite0(nn.Module):
    # expand, out_ch, repeats, stride, kernel: the B0 trunk; Lite keeps the
    # B0 multipliers (1.0 / 1.0) and fixes stem 32 / head 1280
    CFG = [
        (1, 16, 1, 1, 3),
        (6, 24, 2, 2, 3),
        (6, 40, 2, 2, 5),
        (6, 80, 3, 2, 3),
        (6, 112, 3, 1, 5),
        (6, 192, 4, 2, 5),
        (6, 320, 1, 1, 3),
    ]

    def __init__(self, num_classes=1000, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.stem = ConvBNAct(3, 32, stride=2, **kw)
        in_ch = 32
        blocks = []
        for t, c, n, s, k in self.CFG:
            for j in range(n):
                blocks.append(MBConvLite(in_ch, c, k, s if j == 0 else 1, t,
                                         **kw))
                in_ch = c
        self.blocks = nn.Sequential(*blocks)
        self.head = ConvBNAct(in_ch, 1280, kernel=1, **kw)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.flatten = nn.Flatten()
        self.classifier = nn.Linear(1280, num_classes, **kw)

    def forward(self, x):
        y = self.head(self.blocks(self.stem(x)))
        return self.classifier(self.flatten(self.avgpool(y)))


@register_model
def efficientnet_lite0(num_classes=1000, *, generator=None, device=None):
    return EfficientNetLite0(num_classes, generator=generator, device=device)
