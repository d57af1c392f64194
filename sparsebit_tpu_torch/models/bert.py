"""BERT encoder, NLC (port of ``sparsebit_tpu/models/bert.py``; parity
target: the reference's PTQ GLUE/CoLA example and BertEmbeddings CI test,
examples/post_training_quantization/GLUE/CoLA/main.py,
ci/huggingface_tests/test_bert_emebddings.py).

``BertEmbeddings`` looks up positions ``0..L-1`` and token type 0, which
depend on no input value: the tracer folds both lookups into constants,
as the JAX package's graph does.
"""

import torch

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch.models import register_model
from sparsebit_tpu_torch.nn import functional as F


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size, dim, max_len=512, type_vocab=2, *,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.word_embeddings = nn.Embedding(vocab_size, dim, **kw)
        self.position_embeddings = nn.Embedding(max_len, dim, **kw)
        self.token_type_embeddings = nn.Embedding(type_vocab, dim, **kw)
        self.norm = nn.LayerNorm(dim, device=device)

    def forward(self, input_ids):
        L = input_ids.shape[-1]
        device = input_ids.device
        pos = torch.arange(L, dtype=torch.int32, device=device)
        types = torch.zeros((L,), dtype=torch.int32, device=device)
        y = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.token_type_embeddings(types))
        return self.norm(y)


class BertSelfAttention(nn.Module):
    def __init__(self, dim, num_heads, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.query = nn.Linear(dim, dim, **kw)
        self.key = nn.Linear(dim, dim, **kw)
        self.value = nn.Linear(dim, dim, **kw)
        self.output = nn.Linear(dim, dim, **kw)

    def _split(self, x, B, N):
        return F.permute(F.reshape(x, (B, N, self.num_heads, self.head_dim)),
                         (0, 2, 1, 3))

    def forward(self, x):
        B, N, C = x.shape[0], x.shape[1], x.shape[2]
        q = self._split(self.query(x), B, N)
        k = self._split(self.key(x), B, N)
        v = self._split(self.value(x), B, N)
        attn = F.matmul(q, F.transpose(k, 2, 3)) * (self.head_dim ** -0.5)
        attn = F.softmax(attn, axis=-1)
        y = F.reshape(F.permute(F.matmul(attn, v), (0, 2, 1, 3)), (B, N, C))
        return self.output(y)


class BertLayer(nn.Module):
    def __init__(self, dim, num_heads, ffn_dim, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.attention = BertSelfAttention(dim, num_heads, **kw)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.intermediate = nn.Linear(dim, ffn_dim, **kw)
        self.act = nn.GELU()
        self.ffn_output = nn.Linear(ffn_dim, dim, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)

    def forward(self, x):
        x = self.norm1(x + self.attention(x))
        x = self.norm2(x + self.ffn_output(self.act(self.intermediate(x))))
        return x


class BertModel(nn.Module):
    def __init__(self, vocab_size=30522, dim=768, depth=12, num_heads=12,
                 ffn_dim=3072, num_classes=2, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.embeddings = BertEmbeddings(vocab_size, dim, **kw)
        self.encoder = nn.Sequential(
            *[BertLayer(dim, num_heads, ffn_dim, **kw) for _ in range(depth)])
        self.pooler = nn.Linear(dim, dim, **kw)
        self.pooler_act = nn.Tanh()
        self.classifier = nn.Linear(dim, num_classes, **kw)

    def forward(self, input_ids):
        y = self.encoder(self.embeddings(input_ids))
        pooled = self.pooler_act(self.pooler(F.getitem(y, (slice(None), 0))))
        return self.classifier(pooled)


@register_model
def bert_base(num_classes=2, *, generator=None, device=None):
    return BertModel(num_classes=num_classes, generator=generator,
                     device=device)


@register_model
def bert_tiny(num_classes=2, *, generator=None, device=None):
    return BertModel(vocab_size=1024, dim=128, depth=2, num_heads=2,
                     ffn_dim=512, num_classes=num_classes,
                     generator=generator, device=device)


class BertForQuestionAnswering(nn.Module):
    """Extractive-QA head: per-token start / end span logits (reference:
    examples/unstructured_prune/SQuAD/model.py BertForQuestionAnswering,
    ``qa_outputs`` Linear(hidden, 2) over the whole sequence), returned
    as ``(start, end)``, each (B, L)."""

    def __init__(self, vocab_size=30522, dim=768, depth=12, num_heads=12,
                 ffn_dim=3072, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.embeddings = BertEmbeddings(vocab_size, dim, **kw)
        self.encoder = nn.Sequential(
            *[BertLayer(dim, num_heads, ffn_dim, **kw) for _ in range(depth)])
        self.qa_outputs = nn.Linear(dim, 2, **kw)

    def forward(self, input_ids):
        y = self.encoder(self.embeddings(input_ids))
        logits = self.qa_outputs(y)  # (B, L, 2)
        start = F.getitem(logits, (slice(None), slice(None), 0))
        end = F.getitem(logits, (slice(None), slice(None), 1))
        return start, end


@register_model
def bert_qa(*, generator=None, device=None, **kwargs):
    return BertForQuestionAnswering(generator=generator, device=device,
                                    **kwargs)


@register_model
def bert_qa_tiny(*, generator=None, device=None, **kwargs):
    kw = dict(vocab_size=1024, dim=128, depth=2, num_heads=2, ffn_dim=512)
    kw.update(kwargs)
    return BertForQuestionAnswering(generator=generator, device=device, **kw)
