"""GPT-2 decoder, NLC (port of ``sparsebit_tpu/models/gpt2.py``; parity
target: the reference's PTQ wikitext example,
examples/post_training_quantization/wikitext/main.py, GPT-2-small with an
NLC-layout qconfig).

Causal masking is an additive bias: the buffer ``causal_bias`` holds
-1e9 above the diagonal and is sliced to ``[:N, :N]`` in ``forward``, so
the traced graph stays a chain of quantizable matmuls. The tracer reads
the buffer and folds the slice into the constant operand of the ``add``
node, as the JAX package's graph captures it; positions ``0..L-1`` fold
into a constant lookup the same way.
"""

import torch

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch.models import register_model
from sparsebit_tpu_torch.nn import functional as F


class CausalSelfAttention(nn.Module):
    def __init__(self, dim, num_heads, max_len, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.c_attn = nn.Linear(dim, dim * 3, **kw)
        self.c_proj = nn.Linear(dim, dim, **kw)
        mask = torch.full((max_len, max_len), -1e9, dtype=torch.float32,
                          device=device)
        self.register_buffer("causal_bias", torch.triu(mask, diagonal=1))

    def forward(self, x):
        B, N, C = x.shape[0], x.shape[1], x.shape[2]
        qkv = F.reshape(self.c_attn(x),
                        (B, N, 3, self.num_heads, self.head_dim))
        qkv = F.permute(qkv, (2, 0, 3, 1, 4))
        q, k, v = F.getitem(qkv, 0), F.getitem(qkv, 1), F.getitem(qkv, 2)
        attn = F.matmul(q, F.transpose(k, 2, 3)) * (self.head_dim ** -0.5)
        attn = attn + self.causal_bias[:N, :N]
        attn = F.softmax(attn, axis=-1)
        y = F.reshape(F.permute(F.matmul(attn, v), (0, 2, 1, 3)), (B, N, C))
        return self.c_proj(y)


class GPT2Block(nn.Module):
    def __init__(self, dim, num_heads, max_len, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln_1 = nn.LayerNorm(dim, device=device)
        self.attn = CausalSelfAttention(dim, num_heads, max_len, **kw)
        self.ln_2 = nn.LayerNorm(dim, device=device)
        self.c_fc = nn.Linear(dim, dim * 4, **kw)
        self.act = nn.GELU()
        self.c_proj = nn.Linear(dim * 4, dim, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        x = x + self.c_proj(self.act(self.c_fc(self.ln_2(x))))
        return x


class GPT2Model(nn.Module):
    def __init__(self, vocab_size=50257, dim=768, depth=12, num_heads=12,
                 max_len=1024, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.wte = nn.Embedding(vocab_size, dim, **kw)
        self.wpe = nn.Embedding(max_len, dim, **kw)
        self.blocks = nn.Sequential(
            *[GPT2Block(dim, num_heads, max_len, **kw) for _ in range(depth)])
        self.ln_f = nn.LayerNorm(dim, device=device)
        self.lm_head = nn.Linear(dim, vocab_size, bias=False, **kw)

    def forward(self, input_ids):
        L = input_ids.shape[-1]
        pos = torch.arange(L, dtype=torch.int32, device=input_ids.device)
        y = self.wte(input_ids) + self.wpe(pos)
        return self.lm_head(self.ln_f(self.blocks(y)))


@register_model
def gpt2_small(*, generator=None, device=None, **kwargs):
    return GPT2Model(generator=generator, device=device, **kwargs)


@register_model
def gpt2_tiny(*, generator=None, device=None, **kwargs):
    kw = dict(vocab_size=1024, dim=128, depth=2, num_heads=2, max_len=256)
    kw.update(kwargs)
    return GPT2Model(generator=generator, device=device, **kw)
