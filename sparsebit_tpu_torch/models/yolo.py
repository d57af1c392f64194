"""The YOLO family, NHWC (port of ``sparsebit_tpu/models/yolo.py``;
reference: examples/post_training_quantization/coco2017/yolo_series and
coco2017/yolov5): YOLOv3-tiny, YOLOv3 over Darknet-53 (and its Darknet-21
variant), the CSP-scale YOLOv4 and the C3 / SPPF / PAN YOLOv5.

Each model returns its raw per-scale prediction maps (B, H, W,
anchors * (5 + classes)); box decode and NMS are post-processing outside
the quantized graph. Module paths are the JAX package's, so that one yaml
selects the same layers and ``nn.load_jax_state_dict`` carries its
weights.
"""

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch.models import register_model
from sparsebit_tpu_torch.nn import functional as F


class _ConvBNAct(nn.Module):
    """conv (no bias, ``k // 2`` padding) -> BatchNorm -> activation."""

    def __init__(self, c_in, c_out, k, stride, act, *, generator=None,
                 device=None):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2,
                              bias=False, generator=generator, device=device)
        self.bn = nn.BatchNorm2d(c_out, device=device)
        self.act = act

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class ConvBNLeaky(_ConvBNAct):
    def __init__(self, c_in, c_out, k=3, stride=1, **kw):
        super().__init__(c_in, c_out, k, stride, nn.LeakyReLU(0.1), **kw)


class ConvBNMish(_ConvBNAct):
    def __init__(self, c_in, c_out, k=3, stride=1, **kw):
        super().__init__(c_in, c_out, k, stride, nn.Mish(), **kw)


class ConvBNSiLU(_ConvBNAct):
    def __init__(self, c_in, c_out, k=1, stride=1, **kw):
        super().__init__(c_in, c_out, k, stride, nn.SiLU(), **kw)


class YoloV3Tiny(nn.Module):
    def __init__(self, num_classes=80, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        chs = (16, 32, 64, 128, 256, 512)
        self.stem = nn.ModuleList([
            ConvBNLeaky(3 if i == 0 else chs[i - 1], chs[i], **kw)
            for i in range(6)])
        self.pools = nn.ModuleList([nn.MaxPool2d(2, stride=2)
                                    for _ in range(5)])
        self.conv7 = ConvBNLeaky(512, 1024, **kw)
        self.conv8 = ConvBNLeaky(1024, 256, k=1, **kw)
        out_ch = 3 * (5 + num_classes)
        # scale 1 (coarse)
        self.conv9 = ConvBNLeaky(256, 512, **kw)
        self.head1 = nn.Conv2d(512, out_ch, 1, **kw)
        # scale 2 (fine, after upsample + concat with a stem feature)
        self.conv10 = ConvBNLeaky(256, 128, k=1, **kw)
        self.up = nn.Upsample(scale_factor=2, mode="nearest")
        self.conv11 = ConvBNLeaky(128 + 256, 256, **kw)
        self.head2 = nn.Conv2d(256, out_ch, 1, **kw)

    def forward(self, x):
        feats = []
        for i in range(6):
            x = self.stem[i](x)
            feats.append(x)
            if i < 5:
                x = self.pools[i](x)
        x = self.conv8(self.conv7(x))
        p1 = self.head1(self.conv9(x))
        y = self.up(self.conv10(x))
        y = self.conv11(F.concat([y, feats[4]], axis=-1))
        p2 = self.head2(y)
        return p1, p2


@register_model
def yolov3_tiny(num_classes=80, *, generator=None, device=None):
    return YoloV3Tiny(num_classes, generator=generator, device=device)


# ---- full YOLOv3: Darknet-53 backbone + FPN neck + 3 scale heads ----------
# Reference: coco2017/yolo_series/models/yolov3.py (Darknet depth 53,
# num_blocks [1,2,8,8,4]; three _make_embedding branches of alternating
# 1x1/3x3 convs with upsample + concat routing).


class ResLayer(nn.Module):
    """1x1 squeeze -> 3x3 expand with residual (yolov3.py ResLayer)."""

    def __init__(self, ch, **kw):
        super().__init__()
        self.conv1 = ConvBNLeaky(ch, ch // 2, k=1, **kw)
        self.conv2 = ConvBNLeaky(ch // 2, ch, **kw)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class Darknet(nn.Module):
    """Darknet backbone (yolov3.py Darknet): stem + 5 stride-2 stages;
    returns the last three stage features (strides 8/16/32)."""

    def __init__(self, num_blocks=(1, 2, 8, 8, 4), nf=32, **kw):
        super().__init__()
        self.stem = ConvBNLeaky(3, nf, **kw)
        stages = []
        ch = nf
        for nb in num_blocks:
            layers = [ConvBNLeaky(ch, ch * 2, stride=2, **kw)]
            layers += [ResLayer(ch * 2, **kw) for _ in range(nb)]
            stages.append(nn.Sequential(*layers))
            ch *= 2
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats[-3], feats[-2], feats[-1]


class _Embedding(nn.Module):
    """Five alternating 1x1/3x3 CBL convs + 3x3 CBL + 1x1 head conv; the
    5th conv's output is the routing branch (yolov3.py _make_embedding +
    the i == 4 branch tap in forward)."""

    def __init__(self, c_in, filters, out_ch, **kw):
        super().__init__()
        f0, f1 = filters
        self.conv1 = ConvBNLeaky(c_in, f0, k=1, **kw)
        self.conv2 = ConvBNLeaky(f0, f1, **kw)
        self.conv3 = ConvBNLeaky(f1, f0, k=1, **kw)
        self.conv4 = ConvBNLeaky(f0, f1, **kw)
        self.conv5 = ConvBNLeaky(f1, f0, k=1, **kw)
        self.conv6 = ConvBNLeaky(f0, f1, **kw)
        self.head = nn.Conv2d(f1, out_ch, 1, **kw)

    def forward(self, x):
        branch = self.conv5(self.conv4(self.conv3(self.conv2(self.conv1(x)))))
        return self.head(self.conv6(branch)), branch


class _FPNHeads(nn.Module):
    """The three-scale neck and heads YOLOv3 and YOLOv4 share: embed the
    stride-32 feature, upsample its branch into the stride-16 one, then
    into the stride-8 one."""

    def _fpn(self, c_top, nf, out_ch, **kw):
        c3, c4, c5 = nf * 8, nf * 16, nf * 32
        self.out0 = _Embedding(c_top, (c5 // 2, c5), out_ch, **kw)
        self.out1_cbl = ConvBNLeaky(c5 // 2, c4 // 2, k=1, **kw)
        self.up1 = nn.Upsample(scale_factor=2, mode="nearest")
        self.out1 = _Embedding(c4 + c4 // 2, (c4 // 2, c4), out_ch, **kw)
        self.out2_cbl = ConvBNLeaky(c4 // 2, c3 // 2, k=1, **kw)
        self.up2 = nn.Upsample(scale_factor=2, mode="nearest")
        self.out2 = _Embedding(c3 + c3 // 2, (c3 // 2, c3), out_ch, **kw)

    def heads(self, x2, x1, y0):
        p0, b0 = self.out0(y0)
        y1 = F.concat([self.up1(self.out1_cbl(b0)), x1], axis=-1)
        p1, b1 = self.out1(y1)
        y2 = F.concat([self.up2(self.out2_cbl(b1)), x2], axis=-1)
        p2, _ = self.out2(y2)
        return p0, p1, p2


class YoloV3(_FPNHeads):
    def __init__(self, num_classes=80, num_anchors=3,
                 num_blocks=(1, 2, 8, 8, 4), nf=32, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.backbone = Darknet(num_blocks, nf=nf, **kw)
        self._fpn(nf * 32, nf, num_anchors * (5 + num_classes), **kw)

    def forward(self, x):
        x2, x1, x0 = self.backbone(x)
        return self.heads(x2, x1, x0)


@register_model
def yolov3(num_classes=80, *, generator=None, device=None):
    """Full YOLOv3 (Darknet-53): reference yolo_series/models/yolov3.py."""
    return YoloV3(num_classes, generator=generator, device=device)


@register_model
def yolov3_darknet21(num_classes=80, *, generator=None, device=None):
    """Shallow Darknet-21 variant (reference Darknet depth=21 option):
    the same topology at CI size."""
    return YoloV3(num_classes, num_blocks=(1, 1, 2, 2, 1),
                  generator=generator, device=device)


# ---- CSP-scale family: CSPDarknet backbone (YOLOv4 regime) ----------------
# Reference: coco2017/yolo_series/models/yolov4.py: CSP DownSample stages
# (two-branch residual groups with Mish) + SPP; the neck and heads reuse
# the FPN embedding structure.


class CSPStage(nn.Module):
    """CSP downsample stage (yolov4.py DownSample2..5 pattern): stride-2
    conv, split into a shortcut 1x1 branch and a residual-block branch,
    concat, 1x1 merge."""

    def __init__(self, c_in, c_out, n_blocks, **kw):
        super().__init__()
        ch = c_out // 2
        self.down = ConvBNMish(c_in, c_out, stride=2, **kw)
        self.split1 = ConvBNMish(c_out, ch, k=1, **kw)
        self.split2 = ConvBNMish(c_out, ch, k=1, **kw)
        self.blocks = nn.ModuleList([ResLayer(ch, **kw)
                                     for _ in range(n_blocks)])
        self.merge = ConvBNMish(2 * ch, c_out, k=1, **kw)

    def forward(self, x):
        x = self.down(x)
        s = self.split1(x)
        y = self.split2(x)
        for block in self.blocks:
            y = block(y)
        return self.merge(F.concat([y, s], axis=-1))


class SPP(nn.Module):
    """Spatial pyramid pooling (yolov4.py Neck head): parallel maxpools
    at 5/9/13, concat."""

    def __init__(self):
        super().__init__()
        self.p5 = nn.MaxPool2d(5, stride=1, padding=2)
        self.p9 = nn.MaxPool2d(9, stride=1, padding=4)
        self.p13 = nn.MaxPool2d(13, stride=1, padding=6)

    def forward(self, x):
        return F.concat([self.p13(x), self.p9(x), self.p5(x), x], axis=-1)


class YoloV4(_FPNHeads):
    def __init__(self, num_classes=80, num_anchors=3,
                 num_blocks=(1, 2, 8, 8, 4), nf=32, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.stem = ConvBNMish(3, nf, **kw)
        stages = []
        ch = nf
        for nb in num_blocks:
            stages.append(CSPStage(ch, ch * 2, nb, **kw))
            ch *= 2
        self.stages = nn.ModuleList(stages)
        c5 = nf * 32
        self.spp_pre = ConvBNMish(c5, c5 // 2, k=1, **kw)
        self.spp = SPP()
        self.spp_post = ConvBNMish(2 * c5, c5 // 2, k=1, **kw)
        self._fpn(c5 // 2, nf, num_anchors * (5 + num_classes), **kw)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        x2, x1, x0 = feats[-3], feats[-2], feats[-1]
        y0 = self.spp_post(self.spp(self.spp_pre(x0)))
        return self.heads(x2, x1, y0)


@register_model
def yolov4(num_classes=80, *, generator=None, device=None):
    """CSP-scale YOLOv4 (reference yolo_series/models/yolov4.py)."""
    return YoloV4(num_classes, generator=generator, device=device)


@register_model
def yolov4_small(num_classes=80, *, generator=None, device=None):
    """Shallow CSP variant for CI-scale runs."""
    return YoloV4(num_classes, num_blocks=(1, 1, 2, 2, 1),
                  generator=generator, device=device)


# ---- YOLOv5 family: C3/SPPF backbone + PAN neck ---------------------------
# Reference: coco2017/yolov5/models.py: Conv(SiLU), Bottleneck, C3, SPPF,
# upsample/concat PAN; raw per-scale prediction maps out (the reference's
# Detect grid/anchor decode is post-processing).


class Bottleneck5(nn.Module):
    def __init__(self, ch, shortcut=True, **kw):
        super().__init__()
        self.cv1 = ConvBNSiLU(ch, ch, 1, **kw)
        self.cv2 = ConvBNSiLU(ch, ch, 3, **kw)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions (yolov5/models.py:75)."""

    def __init__(self, c_in, c_out, n=1, shortcut=True, **kw):
        super().__init__()
        c_ = c_out // 2
        self.cv1 = ConvBNSiLU(c_in, c_, 1, **kw)
        self.cv2 = ConvBNSiLU(c_in, c_, 1, **kw)
        self.m = nn.Sequential(*[Bottleneck5(c_, shortcut, **kw)
                                 for _ in range(n)])
        self.cv3 = ConvBNSiLU(2 * c_, c_out, 1, **kw)

    def forward(self, x):
        return self.cv3(F.concat([self.m(self.cv1(x)), self.cv2(x)],
                                 axis=-1))


class SPPF(nn.Module):
    """SPP-Fast: three CHAINED k=5 maxpools (yolov5/models.py:93)."""

    def __init__(self, ch, **kw):
        super().__init__()
        c_ = ch // 2
        self.cv1 = ConvBNSiLU(ch, c_, 1, **kw)
        self.p1 = nn.MaxPool2d(5, stride=1, padding=2)
        self.p2 = nn.MaxPool2d(5, stride=1, padding=2)
        self.p3 = nn.MaxPool2d(5, stride=1, padding=2)
        self.cv2 = ConvBNSiLU(4 * c_, ch, 1, **kw)

    def forward(self, x):
        x = self.cv1(x)
        y1 = self.p1(x)
        y2 = self.p2(y1)
        y3 = self.p3(y2)
        return self.cv2(F.concat([x, y1, y2, y3], axis=-1))


class YoloV5(nn.Module):
    """YOLOv5-style CSP detector (depth/width-scaled): stride-2 conv
    stem, C3 stages, SPPF, PAN neck (top-down upsample+concat then
    bottom-up downsample+concat), three 1x1 heads."""

    def __init__(self, num_classes=80, num_anchors=3, depths=(1, 2, 3, 1),
                 nf=16, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        c1, c2, c3, c4 = nf * 2, nf * 4, nf * 8, nf * 16
        out_ch = num_anchors * (5 + num_classes)
        # stem: k=6 s=2 p=2 (the reference's Conv(3, c, 6, 2, 2); k // 2
        # padding would give odd spatial sizes)
        self.stem = nn.Conv2d(3, nf, 6, stride=2, padding=2, bias=False,
                              **kw)
        self.stem_bn = nn.BatchNorm2d(nf, device=device)
        self.stem_act = nn.SiLU()
        self.d1 = ConvBNSiLU(nf, c1, 3, stride=2, **kw)   # /4
        self.c3_1 = C3(c1, c1, depths[0], **kw)
        self.d2 = ConvBNSiLU(c1, c2, 3, stride=2, **kw)   # /8
        self.c3_2 = C3(c2, c2, depths[1], **kw)
        self.d3 = ConvBNSiLU(c2, c3, 3, stride=2, **kw)   # /16
        self.c3_3 = C3(c3, c3, depths[2], **kw)
        self.d4 = ConvBNSiLU(c3, c4, 3, stride=2, **kw)   # /32
        self.c3_4 = C3(c4, c4, depths[3], **kw)
        self.sppf = SPPF(c4, **kw)
        # PAN top-down
        self.up_cv1 = ConvBNSiLU(c4, c3, 1, **kw)
        self.up1 = nn.Upsample(scale_factor=2, mode="nearest")
        self.c3_td1 = C3(2 * c3, c3, 1, shortcut=False, **kw)
        self.up_cv2 = ConvBNSiLU(c3, c2, 1, **kw)
        self.up2 = nn.Upsample(scale_factor=2, mode="nearest")
        self.c3_td2 = C3(2 * c2, c2, 1, shortcut=False, **kw)
        # PAN bottom-up
        self.dn1 = ConvBNSiLU(c2, c2, 3, stride=2, **kw)
        self.c3_bu1 = C3(2 * c2, c3, 1, shortcut=False, **kw)
        self.dn2 = ConvBNSiLU(c3, c3, 3, stride=2, **kw)
        self.c3_bu2 = C3(2 * c3, c4, 1, shortcut=False, **kw)
        self.head_s = nn.Conv2d(c2, out_ch, 1, **kw)
        self.head_m = nn.Conv2d(c3, out_ch, 1, **kw)
        self.head_l = nn.Conv2d(c4, out_ch, 1, **kw)

    def forward(self, x):
        x = self.stem_act(self.stem_bn(self.stem(x)))
        x = self.c3_1(self.d1(x))
        p3 = self.c3_2(self.d2(x))          # /8
        p4 = self.c3_3(self.d3(p3))         # /16
        p5 = self.sppf(self.c3_4(self.d4(p4)))  # /32
        t1 = self.up_cv1(p5)
        y4 = self.c3_td1(F.concat([self.up1(t1), p4], axis=-1))
        t2 = self.up_cv2(y4)
        y3 = self.c3_td2(F.concat([self.up2(t2), p3], axis=-1))
        z4 = self.c3_bu1(F.concat([self.dn1(y3), t2], axis=-1))
        z5 = self.c3_bu2(F.concat([self.dn2(z4), t1], axis=-1))
        return self.head_l(z5), self.head_m(z4), self.head_s(y3)


@register_model
def yolov5s(num_classes=80, *, generator=None, device=None):
    """YOLOv5-small scale (reference coco2017/yolov5/models.py)."""
    return YoloV5(num_classes, depths=(1, 2, 3, 1), nf=32,
                  generator=generator, device=device)


@register_model
def yolov5n(num_classes=80, *, generator=None, device=None):
    """YOLOv5-nano scale (CI size)."""
    return YoloV5(num_classes, depths=(1, 1, 1, 1), nf=16,
                  generator=generator, device=device)
