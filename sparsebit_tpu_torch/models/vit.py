"""DeiT / ViT family, NLC (port of ``sparsebit_tpu/models/vit.py``;
parity target: the reference's PTQ DeiT example and MHSA CI test,
examples/post_training_quantization/imagenet1k/deit/main.py,
ci/regular_tests/test_MHSA.py:31-58).

Attention is written with the port's functional helpers (``F.matmul``,
``F.softmax``, ...) so that the tracer records every product for
quantization, under the JAX package's node names. ``cls_token`` and
``pos_embed`` are read directly by ``forward``: the tracer folds them
into constants, as the JAX package's graph captures its arrays.
"""

import torch

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch.models import register_model
from sparsebit_tpu_torch.nn import functional as F


class Attention(nn.Module):
    def __init__(self, dim, num_heads=8, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, **kw)
        self.proj = nn.Linear(dim, dim, **kw)

    def forward(self, x):
        B, N, C = x.shape[0], x.shape[1], x.shape[2]
        qkv = F.reshape(self.qkv(x), (B, N, 3, self.num_heads,
                                      self.head_dim))
        qkv = F.permute(qkv, (2, 0, 3, 1, 4))  # (3, B, H, N, hd)
        q = F.getitem(qkv, 0)
        k = F.getitem(qkv, 1)
        v = F.getitem(qkv, 2)
        attn = F.matmul(q, F.transpose(k, 2, 3)) * self.scale
        attn = F.softmax(attn, axis=-1)
        y = F.matmul(attn, v)  # (B, H, N, hd)
        y = F.reshape(F.permute(y, (0, 2, 1, 3)), (B, N, C))
        return self.proj(y)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim, **kw)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = Attention(dim, num_heads, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        x = x + self.mlp(self.norm2(x))
        return x


class PatchEmbed(nn.Module):
    def __init__(self, img_size, patch_size, dim, *, generator=None,
                 device=None):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size,
                              generator=generator, device=device)
        self.dim = dim

    def forward(self, x):
        y = self.proj(x)  # (B, H', W', C)
        return F.reshape(y, (y.shape[0], self.num_patches, self.dim))


class VisionTransformer(nn.Module):
    def __init__(self, img_size=224, patch_size=16, dim=192, depth=12,
                 num_heads=3, num_classes=1000, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.patch_embed = PatchEmbed(img_size, patch_size, dim, **kw)
        n_tok = self.patch_embed.num_patches + 1
        self.cls_token = torch.nn.Parameter(torch.empty(
            (1, 1, dim), device=device).normal_(generator=generator) * 0.02)
        self.pos_embed = torch.nn.Parameter(torch.empty(
            (1, n_tok, dim), device=device).normal_(generator=generator)
            * 0.02)
        self.blocks = nn.Sequential(
            *[Block(dim, num_heads, **kw) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, device=device)
        self.head = nn.Linear(dim, num_classes, **kw)
        self.dim = dim

    def forward(self, x):
        y = self.patch_embed(x)
        cls = F.expand(self.cls_token, (y.shape[0], 1, self.dim))
        y = F.concat([cls, y], axis=1) + self.pos_embed
        y = self.norm(self.blocks(y))
        return self.head(F.getitem(y, (slice(None), 0)))


@register_model
def deit_tiny(num_classes=1000, img_size=224, *, generator=None,
              device=None):
    return VisionTransformer(img_size, 16, 192, 12, 3, num_classes,
                             generator=generator, device=device)


@register_model
def deit_small(num_classes=1000, img_size=224, *, generator=None,
               device=None):
    return VisionTransformer(img_size, 16, 384, 12, 6, num_classes,
                             generator=generator, device=device)


@register_model
def deit_base(num_classes=1000, img_size=224, *, generator=None,
              device=None):
    return VisionTransformer(img_size, 16, 768, 12, 12, num_classes,
                             generator=generator, device=device)
