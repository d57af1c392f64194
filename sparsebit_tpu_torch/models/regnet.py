"""RegNetX-600MF, NHWC (port of ``sparsebit_tpu/models/regnet.py``; the
reference's PTQ README table includes it,
examples/post_training_quantization/imagenet1k/basecase/README.md:27-33).
X-block: 1x1 -> 3x3 group conv (group width 24) -> 1x1 with a residual,
ReLU, no squeeze-excite; the 600MF design: depths (1, 3, 5, 7), widths
(48, 96, 240, 528), bottleneck ratio 1. Module paths are the JAX
package's."""

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch.models import register_model


class XBlock(nn.Module):
    def __init__(self, in_ch, out_ch, stride, group_width, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        groups = out_ch // group_width
        self.a = nn.Conv2d(in_ch, out_ch, 1, bias=False, **kw)
        self.a_bn = nn.BatchNorm2d(out_ch, device=device)
        self.b = nn.Conv2d(out_ch, out_ch, 3, stride=stride, padding=1,
                           groups=groups, bias=False, **kw)
        self.b_bn = nn.BatchNorm2d(out_ch, device=device)
        self.c = nn.Conv2d(out_ch, out_ch, 1, bias=False, **kw)
        self.c_bn = nn.BatchNorm2d(out_ch, device=device)
        self.relu = nn.ReLU()
        self.proj = None
        if stride != 1 or in_ch != out_ch:
            self.proj = nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False,
                                  **kw)
            self.proj_bn = nn.BatchNorm2d(out_ch, device=device)

    def forward(self, x):
        y = self.relu(self.a_bn(self.a(x)))
        y = self.relu(self.b_bn(self.b(y)))
        y = self.c_bn(self.c(y))
        sc = self.proj_bn(self.proj(x)) if self.proj is not None else x
        return self.relu(sc + y)


class RegNetX600MF(nn.Module):
    DEPTHS = (1, 3, 5, 7)
    WIDTHS = (48, 96, 240, 528)
    GROUP_W = 24

    def __init__(self, num_classes=1000, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.stem = nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False, **kw)
        self.stem_bn = nn.BatchNorm2d(32, device=device)
        self.stem_relu = nn.ReLU()
        in_ch = 32
        blocks = []
        for d, w in zip(self.DEPTHS, self.WIDTHS):
            for j in range(d):
                blocks.append(XBlock(in_ch, w, 2 if j == 0 else 1,
                                     self.GROUP_W, **kw))
                in_ch = w
        self.blocks = nn.Sequential(*blocks)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(in_ch, num_classes, **kw)

    def forward(self, x):
        y = self.stem_relu(self.stem_bn(self.stem(x)))
        y = self.blocks(y)
        return self.fc(self.flatten(self.avgpool(y)))


@register_model
def regnetx_600mf(num_classes=1000, *, generator=None, device=None):
    return RegNetX600MF(num_classes, generator=generator, device=device)
