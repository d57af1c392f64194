"""ResNet family, NHWC (port of ``sparsebit_tpu/models/resnet.py``):
torchvision's resnet18/34/50 and a cifar resnet20, the models of the
reference's PTQ/QAT basecase examples, written against
``sparsebit_tpu_torch.nn`` so that the tracer captures the whole graph,
residual adds included. Module paths are the JAX package's, so that one
yaml (W/A.SPECIFIC, SKIP_TRACE_MODULES) selects the same layers and
``nn.load_jax_state_dict`` carries its weights."""

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch.models import register_model


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, out_ch, stride=1, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1,
                               bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(out_ch, device=device)
        self.relu1 = nn.ReLU()
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False, **kw)
        self.bn2 = nn.BatchNorm2d(out_ch, device=device)
        self.relu2 = nn.ReLU()
        if stride != 1 or in_ch != out_ch:
            self.down_conv = nn.Conv2d(in_ch, out_ch, 1, stride=stride,
                                       bias=False, **kw)
            self.down_bn = nn.BatchNorm2d(out_ch, device=device)
        else:
            self.down_conv = None

    def forward(self, x):
        idt = x
        y = self.relu1(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.down_conv is not None:
            idt = self.down_bn(self.down_conv(x))
        return self.relu2(y + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch, out_ch, stride=1, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 1, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(out_ch, device=device)
        self.relu1 = nn.ReLU()
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, stride=stride, padding=1,
                               bias=False, **kw)
        self.bn2 = nn.BatchNorm2d(out_ch, device=device)
        self.relu2 = nn.ReLU()
        self.conv3 = nn.Conv2d(out_ch, out_ch * 4, 1, bias=False, **kw)
        self.bn3 = nn.BatchNorm2d(out_ch * 4, device=device)
        self.relu3 = nn.ReLU()
        if stride != 1 or in_ch != out_ch * 4:
            self.down_conv = nn.Conv2d(in_ch, out_ch * 4, 1, stride=stride,
                                       bias=False, **kw)
            self.down_bn = nn.BatchNorm2d(out_ch * 4, device=device)
        else:
            self.down_conv = None

    def forward(self, x):
        idt = x
        y = self.relu1(self.bn1(self.conv1(x)))
        y = self.relu2(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.down_conv is not None:
            idt = self.down_bn(self.down_conv(x))
        return self.relu3(y + idt)


class ResNet(nn.Module):
    def __init__(self, block, layers, num_classes=1000, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                               **kw)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        stages = []
        for n, out_ch, stride in zip(layers, (64, 128, 256, 512),
                                     (1, 2, 2, 2)):
            blocks = []
            for j in range(n):
                blocks.append(block(in_ch, out_ch, stride if j == 0 else 1,
                                    **kw))
                in_ch = out_ch * block.expansion
            stages.append(nn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(in_ch, num_classes, **kw)

    def forward(self, x):
        y = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        y = self.layer4(self.layer3(self.layer2(self.layer1(y))))
        return self.fc(self.flatten(self.avgpool(y)))


class CifarResNet(nn.Module):
    """resnet20-style cifar net: 3 stages of n BasicBlocks."""

    def __init__(self, n=3, num_classes=10, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(16, device=device)
        self.relu = nn.ReLU()
        in_ch = 16
        stages = []
        for out_ch, stride in zip((16, 32, 64), (1, 2, 2)):
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(in_ch, out_ch,
                                         stride if j == 0 else 1, **kw))
                in_ch = out_ch
            stages.append(nn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3 = stages
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(64, num_classes, **kw)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.layer3(self.layer2(self.layer1(y)))
        return self.fc(self.flatten(self.avgpool(y)))


@register_model
def resnet18(num_classes=1000, *, generator=None, device=None):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, generator=generator,
                  device=device)


@register_model
def resnet34(num_classes=1000, *, generator=None, device=None):
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, generator=generator,
                  device=device)


@register_model
def resnet50(num_classes=1000, *, generator=None, device=None):
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, generator=generator,
                  device=device)


@register_model
def resnet20(num_classes=10, *, generator=None, device=None):
    return CifarResNet(3, num_classes, generator=generator, device=device)
