"""Plain PyTorch reference of the decoder that both configurations run
(LLaMA-style: RMSNorm, rotate-half RoPE, grouped-query causal attention,
a SwiGLU FFN and an untied head), written from the published equations
and computed op by op: no kernel, no cache object, no batching across
sequences. It imports neither JAX nor the program under test.

Weights come in as the benchmark made them: integer codes (K, N) in
[0, 16) with group scales and zeros (G, N), dequantized here as
(code - zero) * scale in float32. Activations are held in the model's
dtype where the model stores them (embedding rows, norm outputs, linear
outputs, attention outputs, the residual stream); every operation
computes in float32, with TF32 off.

The quantized arithmetic the configurations state:

- serving: every backbone linear reads its input quantized per token,
  symmetric, to ``act_bits`` (8: W4A8), and K and V are stored quantized
  per token and head to ``kv_bits`` (8: the int8 cache, whose scales are
  held in bfloat16) and read back dequantized in the model's dtype by
  every query; the FFN's SwiGLU is taken in the model's dtype as the
  published models' MLP runs it (silu(g) rounded, then times u);
- training: the frozen backbone's forward product takes operands no
  coarser than bfloat16 with float32 sums (computed here in float32;
  ``forward="bf16"`` rounds x and the dequantized W to bfloat16 first),
  and its input gradient is the product of the output gradient quantized
  per token to int8 and W^T requantized per input channel to int8; the
  SwiGLU as in serving.

The controls are the same code one precision step lower: ``act_bits=4,
kv_bits=4`` for serving (``kv_bits=4`` alone lowers the cache only); for
training ``forward="fp8"``, the forward product on float8 e4m3 operands
(x as it is, W scaled per output column to e4m3's range). ``frozen=True``
plants a fault in the serving reference: the K/V rows of the served
tokens never reach the cache, so each decode position attends to the
prompt's rows and its own.
"""

import math

import torch

F32 = torch.float32


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dims(mc):
    """(dim, layers, heads, kv heads, head_dim, ffn, vocab) of a published
    config.json."""
    D, H = mc["hidden_size"], mc["num_attention_heads"]
    return (D, mc["num_hidden_layers"], H, mc["num_key_value_heads"],
            mc.get("head_dim") or D // H, mc["intermediate_size"],
            mc["vocab_size"])


def dequant(codes, scales, zeros, gs):
    """(K, N) codes with (K / gs, N) scales and zeros -> f32 (K, N)."""
    K, N = codes.shape
    c = codes.reshape(K // gs, gs, N).to(F32)
    z = zeros.to(F32)[:, None]
    s = scales.to(F32)[:, None]
    return ((c - z) * s).reshape(K, N)


def quant_sym(x, bits, scale_dtype=None):
    """x quantized per row (last axis), symmetric, to ``bits`` and
    dequantized: round(x / s) * s with s = absmax * (1 / (2^(bits-1) -
    1)), rounded to ``scale_dtype`` where the format holds it so."""
    qmax = 2 ** (bits - 1) - 1
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * (1.0 / qmax)
    if scale_dtype is not None:
        s = s.to(scale_dtype).to(F32)
    return torch.clamp(torch.round(x / s), -qmax - 1, qmax) * s


def rms_norm(x, w, eps):
    xf = x.to(F32)
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * w


def rope(x, pos, theta):
    """Rotate-half RoPE of x (..., T, H, D) f32 at positions pos (T,)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=F32,
                                       device=x.device) / D)
    ang = pos.to(F32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, frozen_from=None):
    """q (..., T, H, D), k/v (..., T, Hkv, D), f32; kv head j serves query
    heads j * H/Hkv ... With ``frozen_from`` = P, positions t >= P see
    rows < P and their own only. Returns (..., T, H, D) f32."""
    T, H, D = q.shape[-3:]
    rep = H // k.shape[-2]
    k = k.repeat_interleave(rep, dim=-2)
    v = v.repeat_interleave(rep, dim=-2)
    s = torch.einsum("...thd,...shd->...hts", q, k) / math.sqrt(D)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    if frozen_from is not None:
        P = frozen_from
        mask[P:, P:] |= ~torch.eye(T - P, dtype=torch.bool, device=q.device)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("...hts,...shd->...thd", p, v)


def _split_qkv(W, x, lin, mc):
    D, _, H, Hkv, hd, _, _ = dims(mc)
    if "wqkv" in W:
        qkv = lin(x, W["wqkv"])
        q, k, v = qkv.split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
    else:
        q, k, v = (lin(x, W[n]) for n in ("wq", "wk", "wv"))
    lead = x.shape[:-1]
    return (q.reshape(lead + (H, hd)), k.reshape(lead + (Hkv, hd)),
            v.reshape(lead + (Hkv, hd)))


def _ffn(W, x, lin):
    """SwiGLU in the model's dtype, as the published MLP runs it."""
    if "w13" in W:
        g, u = lin(x, W["w13"]).chunk(2, dim=-1)
    else:
        g, u = lin(x, W["w1"]), lin(x, W["w3"])
    return lin(torch.nn.functional.silu(g) * u, W["w2"])


class ServeReference:
    """Greedy serving's logits, teacher-forced. ``layer_weights(li)``
    gives {name: (codes, scales, zeros)} of layer li; ``embed`` (V, D),
    ``head`` (D, V) and ``norms`` = (attn (L, D), ffn (L, D), final (D,))
    in the model's dtype."""

    def __init__(self, mc, layer_weights, embed, head, norms, gs,
                 act_bits=8, kv_bits=8, frozen=False):
        self.mc, self.layer_weights, self.gs = mc, layer_weights, gs
        self.embed, self.head, self.norms = embed, head, norms
        self.act_bits, self.kv_bits, self.frozen = act_bits, kv_bits, frozen

    def _lin(self, x, W):
        xf = quant_sym(x.to(F32), self.act_bits)
        return (xf @ W).to(x.dtype)

    def _layer(self, x, li, W, first):
        mc = self.mc
        eps, theta = mc["rms_norm_eps"], mc["rope_theta"]
        T = x.shape[0]
        pos = torch.arange(T, device=x.device)
        q, k, v = _split_qkv(W, rms_norm(x, self.norms[0][li], eps),
                             self._lin, mc)
        q = rope(q.to(F32), pos, theta).to(x.dtype).to(F32)
        k = rope(k.to(F32), pos, theta).to(x.dtype)
        # the int8 cache holds bf16 scales; K and V are read back in the
        # model's dtype
        sd = torch.bfloat16 if self.kv_bits == 8 else None
        k = quant_sym(k.to(F32), self.kv_bits, sd).to(x.dtype).to(F32)
        v = quant_sym(v.to(F32), self.kv_bits, sd).to(x.dtype).to(F32)
        o = causal_attention(q, k, v, first + 1 if self.frozen else None)
        o = o.reshape(T, -1).to(x.dtype)
        x = x + self._lin(o, W["wo"])
        return x + _ffn(W, rms_norm(x, self.norms[1][li], eps), self._lin)

    @torch.no_grad()
    def logits(self, seqs, first):
        """seqs: 1-D token tensors (a prompt and its served tokens but the
        last); returns, for each, f32 logits (T - first, V) at positions
        first, first + 1, ... (first = prompt length - 1: the position
        whose logits chose the first served token). Layer by layer over
        all sequences, so each layer's weights are dequantized once."""
        no_tf32()
        xs = [self.embed[s.long()] for s in seqs]
        for li in range(dims(self.mc)[1]):
            W = {n: dequant(c, s, z, self.gs)
                 for n, (c, s, z) in self.layer_weights(li).items()}
            xs = [self._layer(x, li, W, f) for x, f in zip(xs, first)]
            del W
        head = self.head.to(F32)
        return [rms_norm(x[f:], self.norms[2], self.mc["rms_norm_eps"]).to(
            F32) @ head for x, f in zip(xs, first)]


E4M3_MAX = 448.0


def forward_product(x, W, mode):
    """x @ W with float32 sums, on operands of ``mode``: "f32"; "tf32"
    (TF32 products); "bf16" (x and W rounded to bfloat16); "fp8" (x cast
    to float8 e4m3, W scaled per output column to e4m3's range and cast).
    Returns float32."""
    xf = x.to(F32)
    if mode == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return xf @ W
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    if mode == "bf16":
        xf = xf.to(torch.bfloat16).to(F32)
        W = W.to(torch.bfloat16).to(F32)
    elif mode == "fp8":
        xf = xf.to(torch.float8_e4m3fn).to(F32)
        s = W.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / E4M3_MAX
        W = (W / s).to(torch.float8_e4m3fn).to(F32) * s
    elif mode != "f32":
        raise ValueError("unknown forward mode {!r}".format(mode))
    return xf @ W


class _FrozenLinear(torch.autograd.Function):
    """y = x @ W (W dequantized by ``get_w(key)``, no gradient) by
    ``forward_product``, stored in x's dtype; dx = int8(g) @ int8(W^T by
    input channel)."""

    @staticmethod
    def forward(ctx, x, get_w, key, mode):
        ctx.get_w, ctx.key, ctx.dtype = get_w, key, x.dtype
        return forward_product(x, get_w(key), mode).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        wt = ctx.get_w(ctx.key).t()
        s_w = wt.abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / 127
        wq = torch.clamp(torch.round(wt / s_w), -127, 127)
        g2 = g.reshape(-1, g.shape[-1]).to(F32)
        s_g = g2.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127
        gq = torch.clamp(torch.round(g2 / s_g), -128, 127)
        dx = (gq @ wq) * s_g * s_w
        return dx.reshape(g.shape[:-1] + (-1,)).to(ctx.dtype), None, None, \
            None


class TrainReference:
    """QLoRA steps: the frozen quantized backbone, f32 adapters
    ``lora[(layer, name)] = (A (K, r), B (r, N))`` added as (x A B) *
    alpha / r on the targets, the mean next-token cross-entropy, and
    AdamW (decoupled decay, bias-corrected moments). ``get_w((li,
    name))`` dequantizes one backbone linear; ``forward`` is the forward
    product's mode (``forward_product``): "f32" (the reference), "tf32"
    or "bf16" (precisions the configuration allows) or "fp8" (the
    control)."""

    def __init__(self, mc, get_w, embed, head, norms, alpha, forward="f32"):
        self.mc, self.get_w, self.alpha, self.mode = mc, get_w, alpha, forward
        self.embed, self.head, self.norms = embed, head, norms

    def loss(self, tokens, lora):
        mc = self.mc
        D, L, H, Hkv, hd, F, V = dims(mc)
        eps, theta = mc["rms_norm_eps"], mc["rope_theta"]
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        Bn, T = inp.shape
        pos = torch.arange(T, device=tokens.device)
        x = self.embed[inp.long()]
        for li in range(L):
            def lin(h, key, li=li):
                name = key
                y = _FrozenLinear.apply(h, self.get_w, (li, name), self.mode)
                if (li, name) in lora:
                    A, B = lora[(li, name)]
                    r = A.shape[1]
                    y = y + ((h.to(F32) @ A) @ B * (self.alpha / r)).to(
                        y.dtype)
                return y

            h = rms_norm(x, self.norms[0][li], eps)
            q, k, v = (lin(h, n).reshape(Bn, T, -1, hd)
                       for n in ("wq", "wk", "wv"))
            q = rope(q.to(F32), pos, theta).to(x.dtype)
            k = rope(k.to(F32), pos, theta).to(x.dtype)
            o = causal_attention(q.to(F32), k.to(F32), v.to(F32))
            x = x + lin(o.reshape(Bn, T, H * hd).to(x.dtype), "wo")
            h = rms_norm(x, self.norms[1][li], eps)
            a = torch.nn.functional.silu(lin(h, "w1")) * lin(h, "w3")
            x = x + lin(a, "w2")
        h = rms_norm(x, self.norms[2], eps)
        logits = h.to(F32) @ self.head.to(F32)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, tgt[..., None].long())[..., 0].mean()

    def steps(self, batches, lora0, lr, betas, eps, weight_decay):
        """AdamW over the adapters, one step a batch, from ``lora0``.
        Returns (losses, the first step's gradients {leaf: tensor}, the
        adapters after the last step {leaf: tensor}, each leaf's largest
        gradient norm over the steps); a leaf is (layer, name, "A" or
        "B")."""
        no_tf32()
        leaves = {}
        for (li, name), (A, B) in lora0.items():
            leaves[(li, name, "A")] = A.detach().clone().requires_grad_()
            leaves[(li, name, "B")] = B.detach().clone().requires_grad_()
        m = {k: torch.zeros_like(t) for k, t in leaves.items()}
        v = {k: torch.zeros_like(t) for k, t in leaves.items()}
        b1, b2 = betas
        losses, first, gmax = [], None, dict.fromkeys(leaves, 0.0)
        for t, tokens in enumerate(batches, start=1):
            lora = {(li, n): (leaves[(li, n, "A")], leaves[(li, n, "B")])
                    for (li, n) in lora0}
            loss = self.loss(tokens, lora)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
            g = dict(zip(leaves, grads))
            if first is None:
                first = {k: x.detach().clone() for k, x in g.items()}
            for k, x in g.items():
                gmax[k] = max(gmax[k], float(x.norm()))
            with torch.no_grad():
                for k, p in leaves.items():
                    p.mul_(1 - lr * weight_decay)
                    m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                    denom = (v[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
            del loss, grads, g
        return (losses, first, {k: t.detach() for k, t in leaves.items()},
                gmax)
