"""BEVDet-lite: multi-camera bird's-eye-view 3D detection, NHWC (port of
``sparsebit_tpu/models/bevdet.py``; reference:
examples/quantization_aware_training/nuscenes/bevdet, whose
``BEVDetTraced`` (qbevdet.py:19-28) quantizes the image backbone / neck,
the depthnet, the BEV encoder and the CenterPoint-style head around an
unquantized lift-splat view transform).

The camera -> BEV assignment is static (pinhole geometry fixed at build
time): ``cell_ids`` gives each frustum point (camera, v, u, depth bin) its
BEV cell, or the drop cell ``Hb * Wb`` when it falls outside the grid.
``LSSViewTransform`` is a leaf module (it computes in ``execute``), so the
tracer records it as one float node that QuantModel leaves unconverted,
the quantization boundary the reference draws.

Pooling. The JAX package sums the points into their cells with one
``jax.ops.segment_sum``. A CUDA scatter-add adds with atomics, in an order
that changes from call to call and differs from the CPU's. Here each cell
lists its points in increasing point order (a table of ``Hb * Wb`` rows
and as many slots as the fullest cell holds, the empty slots pointing at
an appended zero point), the points are gathered through that table once,
and the slots are added one after another: the same additions in the same
order on every device and every call, the order of the CPU's
segment-sum. Its backward is the gather's, which writes each point's
gradient once (a point sits in one slot). The drop cell is never summed.
"""

import numpy as np
import torch

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch.models import register_model


class ConvBNReLU(nn.Module):
    def __init__(self, c_in, c_out, k=3, stride=1, *, generator=None,
                 device=None):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2,
                              bias=False, generator=generator, device=device)
        self.bn = nn.BatchNorm2d(c_out, device=device)
        self.act = nn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


def _lss_cell_ids(n_cams, feat_h, feat_w, depth_bins, bev_h, bev_w,
                  fov_deg=90.0, d0=1.0, d_step=1.0, bev_range=12.0):
    """Static pinhole ring geometry -> BEV cell id per (cam, v, u, d).

    Cameras sit at the ego origin, yawed 360/n_cams degrees apart, each
    with a horizontal FOV ``fov_deg``. Depth bin j is at metric depth
    d0 + j*d_step along the optical axis. The (x, y) ego-frame hit is
    binned on a (bev_h, bev_w) grid spanning [-bev_range, bev_range].
    Out-of-grid points map to the drop cell bev_h*bev_w (sliced off).
    Returns (n_cams * feat_h * feat_w * depth_bins,) int32 in
    [0, bev_h*bev_w], ordered (cam, v, u, d) to match the flattened
    (BN, h, w, D) feature layout."""
    f = (feat_w / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    cx = (feat_w - 1) / 2.0
    u = np.arange(feat_w)
    v = np.arange(feat_h)
    d = d0 + d_step * np.arange(depth_bins)
    # camera frame: +z optical axis, +x right; rays through pixel centers
    vv, uu, dd = np.meshgrid(v, u, d, indexing="ij")  # (h, w, D)
    x_cam = (uu - cx) / f * dd
    z_cam = dd.astype(np.float64)
    ids = []
    for i in range(n_cams):
        yaw = 2.0 * np.pi * i / n_cams
        x_ego = np.cos(yaw) * z_cam - np.sin(yaw) * x_cam
        y_ego = np.sin(yaw) * z_cam + np.cos(yaw) * x_cam
        res_x = 2.0 * bev_range / bev_w
        res_y = 2.0 * bev_range / bev_h
        col = np.floor((x_ego + bev_range) / res_x).astype(np.int64)
        row = np.floor((y_ego + bev_range) / res_y).astype(np.int64)
        ok = (col >= 0) & (col < bev_w) & (row >= 0) & (row < bev_h)
        cid = np.where(ok, row * bev_w + col, bev_h * bev_w)
        ids.append(cid.reshape(-1))  # (h*w*D,) in (v, u, d) order
    return np.concatenate(ids).astype(np.int32)


def cell_slots(ids, n_cells):
    """(n_cells, K) int64: row c lists the points of cell c in increasing
    order, K the most any cell holds; empty slots hold ``len(ids)`` (the
    zero point appended to the gathered features). Cells >= n_cells (the
    drop cell) get no row."""
    ids = ids.long()
    P = ids.numel()
    order = torch.argsort(ids, stable=True)  # by cell, then by point
    counts = torch.bincount(ids, minlength=n_cells + 1)
    start = torch.cumsum(counts, 0) - counts
    cell = ids[order]
    rank = torch.arange(P, device=ids.device) - start[cell]
    keep = cell < n_cells
    K = max(int(counts[:n_cells].max()), 1)
    slots = torch.full((n_cells, K), P, dtype=torch.int64, device=ids.device)
    slots[cell[keep], rank[keep]] = order[keep]
    return slots


def lss_pool(flat, ids, n_cells):
    """(B, P, C) point features summed into their cells, (B, n_cells, C),
    slot by slot in increasing point order (see the module docstring)."""
    B, P, C = flat.shape
    slots = cell_slots(ids, n_cells)
    pad = torch.cat([flat, flat.new_zeros(B, 1, C)], dim=1)
    g = pad[:, slots.reshape(-1)].reshape(B, n_cells, slots.shape[1], C)
    acc = g[:, :, 0]
    for k in range(1, slots.shape[1]):
        acc = acc + g[:, :, k]
    return acc


class LSSViewTransform(nn.Module):
    """Lift-splat: softmax depth distribution x context outer product,
    pooled onto the BEV grid through the static ``cell_ids`` (see the
    module docstring). A leaf: one float node in the quant graph, as the
    reference's unquantized img_view_transformer (qbevdet.py:19-28,
    44-50)."""

    def __init__(self, n_cams, feat_hw, depth_bins, ctx_ch, bev_hw, *,
                 device=None, **geom_kw):
        super().__init__()
        self.n_cams = n_cams
        self.feat_hw = tuple(feat_hw)
        self.depth_bins = depth_bins
        self.ctx_ch = ctx_ch
        self.bev_hw = tuple(bev_hw)
        h, w = self.feat_hw
        ids = _lss_cell_ids(n_cams, h, w, depth_bins, *self.bev_hw, **geom_kw)
        self.register_buffer("cell_ids", torch.from_numpy(ids).to(device))

    def execute(self, x, params=None, training=False):
        # x (B*n_cams, h, w, depth_bins + ctx_ch): the depthnet output,
        # whose input-side quantizer is the reference's LSS-input quant
        D, C = self.depth_bins, self.ctx_ch
        Hb, Wb = self.bev_hw
        BN, h, w, _ = x.shape
        B = BN // self.n_cams
        depth = torch.softmax(x[..., :D].float(), dim=-1)
        ctx = x[..., D:].float()
        # frustum features (BN, h, w, D, C), flattened in cell_ids' order
        feat = depth[..., :, None] * ctx[..., None, :]
        flat = feat.reshape(B, self.n_cams * h * w * D, C)
        pooled = lss_pool(flat, self.get(params, "cell_ids"), Hb * Wb)
        return pooled.reshape(B, Hb, Wb, C).to(x.dtype)


class BEVDetLite(nn.Module):
    """Input: (B * n_cams, H, W, 3), the cameras flattened onto the batch
    axis as the reference's ``imgs.view(B*N, C, H, W)`` (qbevdet.py:33-40).
    Returns (heatmap (B, Hb, Wb, num_classes), boxes (B, Hb, Wb, 8))."""

    def __init__(self, n_cams=4, num_classes=10, img_hw=(64, 96),
                 depth_bins=16, ctx_ch=32, bev_hw=(32, 32), *,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.n_cams = n_cams
        # image encoder: stride-8 conv stack (reference: ResNet-50 / VoVNet)
        self.img_backbone = nn.Sequential(
            ConvBNReLU(3, 32, stride=2, **kw),
            ConvBNReLU(32, 64, stride=2, **kw),
            ConvBNReLU(64, 64, stride=2, **kw),
        )
        self.img_neck = ConvBNReLU(64, 64, k=1, **kw)
        feat_hw = (img_hw[0] // 8, img_hw[1] // 8)
        # depthnet: 1x1 conv -> depth logits + context (LSS)
        self.depthnet = nn.Conv2d(64, depth_bins + ctx_ch, 1, **kw)
        self.view_transform = LSSViewTransform(
            n_cams, feat_hw, depth_bins, ctx_ch, bev_hw, device=device)
        # BEV encoder (reference: img_bev_encoder_backbone + neck)
        self.bev_backbone = nn.Sequential(
            ConvBNReLU(ctx_ch, 64, **kw),
            ConvBNReLU(64, 64, **kw),
        )
        self.bev_neck = ConvBNReLU(64, 64, k=1, **kw)
        # CenterPoint-lite head (reference: shared_conv + task_heads)
        self.shared_conv = ConvBNReLU(64, 64, **kw)
        self.heatmap_head = nn.Conv2d(64, num_classes, 1, **kw)
        self.box_head = nn.Conv2d(64, 8, 1, **kw)

    def forward(self, imgs):
        x = self.img_backbone(imgs)
        x = self.img_neck(x)
        x = self.depthnet(x)
        bev = self.view_transform(x)
        bev = self.bev_backbone(bev)
        bev = self.bev_neck(bev)
        s = self.shared_conv(bev)
        return self.heatmap_head(s), self.box_head(s)


@register_model
def bevdet_lite(n_cams=4, num_classes=10, img_hw=(64, 96), *, generator=None,
                device=None):
    return BEVDetLite(n_cams=n_cams, num_classes=num_classes, img_hw=img_hw,
                      generator=generator, device=device)
