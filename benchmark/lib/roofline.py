"""The least time of the work a run does, from its shapes alone: the
peaks of one NVIDIA H100 SXM (the data sheet's dense rates at 700 W, the
table and arithmetic of ``chip_smoke.bound_ms``) and the operations and
bytes of each piece of work.

A piece of work is ``(ops, nbytes)`` with ``ops`` a dict of operations by
arithmetic ("int8", "bf16", "f32"). Its least time is the larger of its
bytes over the HBM rate and the sum of its operations over their peaks.
Only the work the inputs need is counted: real prompt tokens, not the
bucket they are padded to; the rows each active slot attends to, not the
context bucket; no recomputation. Each input byte is read once and each
output byte written once.
"""

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def least_s(ops, nbytes):
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return max(t_ops, nbytes / HBM_BYTES_S)


def add(*works):
    ops, nbytes = {}, 0
    for o, b in works:
        for k, n in o.items():
            ops[k] = ops.get(k, 0) + n
        nbytes += b
    return ops, nbytes


def shapes(mc):
    D, H = mc["hidden_size"], mc["num_attention_heads"]
    Hkv, F = mc["num_key_value_heads"], mc["intermediate_size"]
    hd = mc.get("head_dim") or D // H
    return D, mc["num_hidden_layers"], H, Hkv, hd, F, mc["vocab_size"]


def serve_linears(mc):
    """(K, N) of a layer's four fused serving linears."""
    D, _, H, Hkv, hd, F, _ = shapes(mc)
    return [(D, (H + 2 * Hkv) * hd), (H * hd, D), (D, 2 * F), (F, D)]


def w4_bytes(K, N, gs, qparam_bytes):
    """Packed 4-bit codes plus one scale and one zero a group column."""
    return K * N // 2 + 2 * (K // gs) * N * qparam_bytes


def k1_launch(T, K, N, gs, qparam_bytes=2, out_bytes=2):
    """One W4A8 product of T tokens: int8 rows in, the weights once,
    rows out in the model's dtype."""
    return ({"int8": 2 * T * K * N},
            w4_bytes(K, N, gs, qparam_bytes) + T * K + T * N * out_bytes)


def k1_group(mc, lens):
    """Every K1 launch of one admission group of real prompt lengths
    ``lens``: four linears a layer over sum(lens) tokens."""
    gs = mc["quantization"]["group_size"]
    T = sum(lens)
    L = shapes(mc)[1]
    return add(*[k1_launch(T, K, N, gs) for K, N in serve_linears(mc)] * L)


def causal_attention(H, hd, lens, products=2):
    """bf16 operations of causal attention over sequences of ``lens``
    (``products`` matrix products of the score's shape: 2 forward)."""
    return {"bf16": products * 2 * H * hd * sum(n * (n + 1) // 2
                                               for n in lens)}


def k10_forward(batch, seq, H, Hkv, hd):
    """One bf16 causal flash forward over ``batch`` sequences of ``seq``
    tokens: the causal half of its two products; q, k, v read and o
    written in bf16, and the f32 lse of each query row written."""
    return (causal_attention(H, hd, [seq] * batch),
            batch * seq * ((2 * H + 2 * Hkv) * hd * 2 + H * 4))


def head_rows(mc, rows, passes=1):
    """The untied bf16 head on ``rows`` rows (``passes`` products of its
    shape: 1 forward, 2 with the input gradient)."""
    D, V = mc["hidden_size"], mc["vocab_size"]
    return ({"bf16": passes * 2 * rows * D * V},
            D * V * 2 + rows * D * 2 + rows * V * 4)


def admission_group(mc, lens):
    """The prefill of one admission group: its K1 launches, attention
    over each real prompt, K/V rows written to the cache (int8 codes and
    f32 scales), and the head on each prompt's last row."""
    D, L, H, Hkv, hd, F, V = shapes(mc)
    kv_write = L * sum(lens) * Hkv * (hd + 4) * 2
    return add(k1_group(mc, lens),
               ({"bf16": L * causal_attention(H, hd, lens)["bf16"]},
                kv_write),
               head_rows(mc, len(lens)))


def k4_step(mc, ctx):
    """One decode token step of K4 for active slots whose caches hold
    ``ctx`` rows before the step: every layer's weights once, the int8
    K/V (and f32 scales) of each slot's ctx + 1 rows read, the new row
    written; int8 products of the linears per slot and bf16 attention."""
    D, L, H, Hkv, hd, F, V = shapes(mc)
    gs = mc["quantization"]["group_size"]
    wb = L * sum(w4_bytes(K, N, gs, 2) for K, N in serve_linears(mc))
    rows = sum(c + 1 for c in ctx)
    kv_read = L * rows * Hkv * (hd + 4) * 2
    kv_write = L * len(ctx) * Hkv * (hd + 4) * 2
    lin_ops = 2 * L * len(ctx) * sum(K * N for K, N in serve_linears(mc))
    attn_ops = 2 * 2 * L * H * hd * rows
    return ({"int8": lin_ops, "bf16": attn_ops},
            wb + kv_read + kv_write + 2 * len(ctx) * D * 4)


def decode_step(mc, ctx):
    """A whole decode token step: K4 and the head on the active rows."""
    return add(k4_step(mc, ctx), head_rows(mc, len(ctx)))


def train_linears(mc):
    D, _, H, Hkv, hd, F, _ = shapes(mc)
    return [(D, H * hd), (D, Hkv * hd), (D, Hkv * hd), (H * hd, D), (D, F),
            (D, F), (F, D)]


def train_step(mc, batch, seq, lora_targets, r):
    """One QLoRA step over batch x seq tokens, at the arithmetic the
    configuration states: the backbone's forward products on bf16
    operands over the dequantized weights, its input-gradient products
    in int8,
    attention (two forward and four backward products of the score's
    shape) and the head (forward and input gradient) in bf16, the
    adapters in f32 (forward, and the gradients of the input, A and B).
    Bytes: the packed weights, f32 qparams and the int8 W^T once, the
    head and its rows once, the logits written once in f32."""
    D, L, H, Hkv, hd, F, V = shapes(mc)
    gs = mc["quantization"]["group_size"]
    T = batch * seq
    lins = train_linears(mc)
    fwd = L * sum(2 * T * K * N for K, N in lins)
    int8 = L * sum(2 * T * K * N for K, N in lins)
    lora = 0
    for K, N in (dict(zip(("wq", "wk", "wv", "wo", "w1", "w3", "w2"), lins))[
            t] for t in lora_targets):
        lora += L * 3 * 2 * T * r * (K + N)
    attn = L * causal_attention(H, hd, [seq] * batch, products=6)["bf16"]
    head_ops, head_b = head_rows(mc, T, passes=2)
    wbytes = L * sum(w4_bytes(K, N, gs, 4) + K * N for K, N in lins)
    return ({"f32": lora, "int8": int8,
             "bf16": fwd + attn + head_ops["bf16"]}, wbytes + head_b)
