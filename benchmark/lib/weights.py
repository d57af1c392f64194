"""The weights of a configuration, made on the device from the seed.

Every backbone linear of every layer is GPTQ-style INT4 with groups of
``group_size`` rows: codes uniform in [0, 16), zeros drawn per group and
column from the integers 6 .. 9 around the codes' mean, and scales
U(0.5, 1.5) / (sd of the codes * sqrt(K)), so that each linear keeps its
input's scale and the residual stream stays O(1) over the depth (the
``unit`` scales of ``chip_smoke.build_random_params``; its default
scales make rows of ~1e3 by the first layer). The query and key
projections' scales are multiplied by sqrt(``score_sd``) of the
configuration (1 where it has none), so that attention scores spread
with that sd. Norm weights are U(0.8, 1.2), the embedding N(0, 1) and
the untied head N(0, 1 / dim), all in the model's dtype.

Each tensor kind is one call over the whole layer stack, from a
generator seeded by (seed, kind): the reference draws the same codes
again, after the program's copy is freed, without taking anything the
program made. ``serving_params`` and ``training_params`` hand the codes
to the program in the layouts it serves and trains.
"""

import hashlib

import torch

SERVE_LINEARS = ("wqkv", "wo", "w13", "w2")
TRAIN_LINEARS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
CODE_SD = ((16 ** 2 - 1) / 12.0) ** 0.5  # sd of codes uniform in [0, 16)


def sub_seed(seed, tag):
    """A 63-bit seed for one tensor kind, from the run's seed (any
    integer) and the kind's name."""
    h = hashlib.sha256("{}:{}".format(int(seed), tag).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def linear_shapes(mc, names):
    D, H, Hkv = (mc["hidden_size"], mc["num_attention_heads"],
                 mc["num_key_value_heads"])
    hd = mc.get("head_dim") or D // H
    F = mc["intermediate_size"]
    shapes = {"wqkv": (D, (H + 2 * Hkv) * hd), "wq": (D, H * hd),
              "wk": (D, Hkv * hd), "wv": (D, Hkv * hd), "wo": (H * hd, D),
              "w13": (D, 2 * F), "w1": (D, F), "w3": (D, F), "w2": (F, D)}
    return {n: shapes[n] for n in names}


class Maker:
    """Weights of the model config ``mc`` (published keys plus its
    ``quantization`` block) for ``seed`` on ``device``."""

    def __init__(self, mc, seed, device):
        self.mc, self.seed, self.device = mc, seed, torch.device(device)
        q = mc["quantization"]
        self.gs = q["group_size"]
        self.qdtype = getattr(torch, q["qparam_dtype"])
        self.dtype = getattr(torch, mc["torch_dtype"])
        self.L = mc["num_hidden_layers"]
        self.names = SERVE_LINEARS if q["fused"] else TRAIN_LINEARS
        self.shapes = linear_shapes(mc, self.names)

    def _gen(self, tag):
        return torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, tag))

    def codes(self, name):
        K, N = self.shapes[name]
        return torch.randint(0, 16, (self.L, K, N), dtype=torch.uint8,
                             generator=self._gen("codes." + name),
                             device=self.device)

    def scales(self, name):
        K, N = self.shapes[name]
        s = torch.empty((self.L, K // self.gs, N), device=self.device)
        s.uniform_(0.5, 1.5, generator=self._gen("scales." + name))
        s /= CODE_SD * K ** 0.5
        gain = float(self.mc.get("score_sd", 1.0)) ** 0.5
        qk = self.qk_columns(name)
        if gain != 1.0 and qk is not None:
            s[..., :qk] *= gain
        return s.to(self.qdtype)

    def qk_columns(self, name):
        """The leading columns of ``name`` that project queries or keys:
        all of wq and wk, the query and key heads of the fused wqkv."""
        D, H = self.mc["hidden_size"], self.mc["num_attention_heads"]
        hd = self.mc.get("head_dim") or D // H
        return {"wq": H * hd, "wk": self.mc["num_key_value_heads"] * hd,
                "wqkv": (H + self.mc["num_key_value_heads"]) * hd}.get(name)

    def zeros(self, name):
        K, N = self.shapes[name]
        z = torch.randint(6, 10, (self.L, K // self.gs, N),
                          generator=self._gen("zeros." + name),
                          device=self.device)
        return z.to(self.qdtype)

    def embed(self):
        V, D = self.mc["vocab_size"], self.mc["hidden_size"]
        return torch.randn((V, D), generator=self._gen("embed"),
                           device=self.device).to(self.dtype)

    def head(self):
        V, D = self.mc["vocab_size"], self.mc["hidden_size"]
        return (torch.randn((D, V), generator=self._gen("head"),
                            device=self.device) * D ** -0.5).to(self.dtype)

    def norms(self):
        """(attention norms (L, D), FFN norms (L, D), final norm (D,))."""
        D = self.mc["hidden_size"]
        w = torch.empty((2 * self.L + 1, D), device=self.device)
        w.uniform_(0.8, 1.2, generator=self._gen("norms"))
        w = w.to(self.dtype)
        return w[:self.L], w[self.L:2 * self.L], w[2 * self.L]

    def layer_weights(self, stacks):
        """{name: (codes, scales, zeros)} stacks -> a function of the layer
        index returning that layer's slices (the reference's input)."""
        return lambda li: {n: tuple(t[li] for t in v)
                           for n, v in stacks.items()}

    def stacks(self):
        return {n: (self.codes(n), self.scales(n), self.zeros(n))
                for n in self.names}


def llama_config(mc):
    """The program's LlamaConfig for a published config.json."""
    from sparsebit_tpu_torch.llm.llama import LlamaConfig

    D, H = mc["hidden_size"], mc["num_attention_heads"]
    if (mc.get("head_dim") or D // H) != D // H:
        raise ValueError("the program derives head_dim as dim / heads")
    return LlamaConfig(
        vocab_size=mc["vocab_size"], dim=D, n_layers=mc["num_hidden_layers"],
        n_heads=H, n_kv_heads=mc["num_key_value_heads"],
        ffn_dim=mc["intermediate_size"],
        max_seq_len=mc["max_position_embeddings"],
        rope_theta=float(mc["rope_theta"]), rms_eps=mc["rms_norm_eps"],
        dtype=mc["torch_dtype"])


def _program_params(maker, linear):
    """The program's params dict; ``linear(name, codes, scales, zeros)``
    returns the per-layer QuantLinears of one linear's stacks."""
    from sparsebit_tpu_torch.llm.quant import DenseLinear

    per_name = {}
    for n in maker.names:
        per_name[n] = linear(n, maker.codes(n), maker.scales(n),
                             maker.zeros(n))
    attn, ffn, final = maker.norms()
    layers = [dict({n: per_name[n][li] for n in maker.names},
                   attn_norm=attn[li], ffn_norm=ffn[li])
              for li in range(maker.L)]
    return {"tok_embed": maker.embed(), "layers": layers, "norm": final,
            "lm_head": DenseLinear(maker.head())}


def serving_params(maker):
    """Fused wqkv / wo / w13 / w2 in the engine's serving layout: signed
    row-pair nibbles (``s4r``, packed by the program), bf16 qparams, the
    W4A8 impl; each layer's linear is a view of the packed stack."""
    from sparsebit_tpu_torch.llm.quant import QuantLinear
    from sparsebit_tpu_torch.ops.packing import pack_s4_rows

    def linear(name, codes, s, z):
        packed = pack_s4_rows(codes)
        del codes
        N = s.shape[-1]
        return [QuantLinear({"s4r": packed[li]}, s[li], z[li], 4, maker.gs,
                            N, impl="a8") for li in range(maker.L)]

    return _program_params(maker, linear)


def training_params(maker):
    """Unfused wq / wk / wv / wo / w1 / w3 / w2 in the checkpoint layout
    QLoRA trains (``load_quant_checkpoint``'s): column-plane nibbles
    packed by the program, f32 qparams, impl "auto"."""
    from sparsebit_tpu_torch.llm.quant import QuantLinear
    from sparsebit_tpu_torch.ops.packing import pack_columns

    def linear(name, codes, s, z):
        packed = pack_columns(codes, 4)["w"]
        del codes
        N = s.shape[-1]
        return [QuantLinear({"w": packed[li]}, s[li], z[li], 4, maker.gs, N)
                for li in range(maker.L)]

    return _program_params(maker, linear)
