"""QLoRA: LoRA adapters over a frozen quantized backbone (port of
``sparsebit_tpu/llm/qlora.py``).

``LoraLinear`` wraps a frozen QuantLinear or DenseLinear and adds
``x @ A @ B · scaling`` in f32. The backbone's linears pass a gradient to
their input only (``ops/quant_matmul``'s autograd.Functions), so a
backward of the loss reaches nothing but the adapters' A and B and the
activations between them. Attention differentiates through K10/K11/K12 on
the card (``ops/flash_attention``), through the masked scores elsewhere.

The JAX package is functional (optax state, new pytrees a step); here the
adapters are tensors that a ``torch.optim`` optimiser updates in place:
``lora_parameters`` marks them trainable, ``adamw`` builds the optimiser
with optax.adamw's defaults, and ``qlora_train_step`` runs one step.
"""

import torch

from sparsebit_tpu_torch.llm.llama import llama_loss
from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear


def _device(lin):
    return lin.scales.device if isinstance(lin, QuantLinear) else lin.w.device


class LoraLinear:
    """A frozen linear plus trainable lora_A (K, r) and lora_B (r, N) in
    f32 (qlora.py:24-85)."""

    def __init__(self, base, lora_A, lora_B, alpha=16.0, dropout=0.0):
        self.base = base
        self.lora_A = lora_A
        self.lora_B = lora_B
        self.alpha = alpha
        self.dropout = dropout

    @property
    def r(self):
        return self.lora_A.shape[1]

    @property
    def scaling(self):
        return self.alpha / self.r

    @property
    def out_features(self):
        return self.base.out_features

    @classmethod
    def wrap(cls, base, r=8, alpha=16.0, generator=None):
        """A ~ N(0, 1/K) drawn from ``generator`` (default: one on the
        base's device seeded 0) on its own device, B = 0, so that the
        wrapped linear starts as the base."""
        dev = _device(base)
        g = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        K, N = base.in_features, base.out_features
        lora_A = torch.randn((K, r), generator=g, device=g.device).to(dev) \
            * (1.0 / max(K, 1)) ** 0.5
        lora_B = torch.zeros((r, N), dtype=torch.float32, device=dev)
        return cls(base, lora_A, lora_B, alpha)

    def __call__(self, x):
        y = self.base(x)
        lora = torch.matmul(torch.matmul(x.to(torch.float32), self.lora_A),
                            self.lora_B) * self.scaling
        return y + lora.to(y.dtype)

    def merge(self):
        """Fold the adapter into a dense f32 weight (inference)."""
        w = (self.base.dequantize() if isinstance(self.base, QuantLinear)
             else self.base.w.to(torch.float32))
        w = w + torch.matmul(self.lora_A, self.lora_B) * self.scaling
        return DenseLinear(w, getattr(self.base, "bias", None))


DEFAULT_TARGETS = ("wq", "wv")  # the reference finetune's q/v projections


def wrap_llama_lora(params, r=8, alpha=16.0, targets=DEFAULT_TARGETS,
                    generator=None):
    """Wrap the ``targets`` linears of every decoder layer in adapters
    (qlora.py:91-103), A drawn layer by layer, target by target, from
    ``generator``."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new_layer = dict(layer)
        for name in targets:
            if generator is None:
                generator = torch.Generator(
                    device=_device(layer[name])).manual_seed(0)
            new_layer[name] = LoraLinear.wrap(layer[name], r, alpha,
                                              generator)
        out["layers"].append(new_layer)
    return out


def merge_llama_lora(params):
    def mrg(x):
        return x.merge() if isinstance(x, LoraLinear) else x

    out = dict(params)
    out["layers"] = [{k: mrg(v) for k, v in layer.items()}
                     for layer in params["layers"]]
    out["lm_head"] = mrg(params["lm_head"])
    return out


def extract_lora(params):
    """{(layer, name): {"lora_A", "lora_B"}}: the adapters' tensors (the
    same objects, not copies)."""
    out = {}
    for i, layer in enumerate(params["layers"]):
        for name, lin in layer.items():
            if isinstance(lin, LoraLinear):
                out[(i, name)] = {"lora_A": lin.lora_A, "lora_B": lin.lora_B}
    return out


def inject_lora(params, lora):
    out = dict(params)
    out["layers"] = []
    for i, layer in enumerate(params["layers"]):
        new_layer = dict(layer)
        for name, lin in layer.items():
            if (i, name) in lora:
                new_layer[name] = LoraLinear(
                    lin.base, lora[(i, name)]["lora_A"],
                    lora[(i, name)]["lora_B"], lin.alpha, lin.dropout)
        out["layers"].append(new_layer)
    return out


def lora_parameters(lora):
    """The adapters' tensors in a fixed order (layer, name, A then B),
    each marked to require a gradient: what an optimiser trains."""
    leaves = [lora[key][leaf] for key in sorted(lora)
              for leaf in ("lora_A", "lora_B")]
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def adamw(lora, lr, weight_decay=1e-4):
    """``torch.optim.AdamW`` over the adapters with optax.adamw's
    defaults: b1 0.9, b2 0.999, eps 1e-8 and weight_decay 1e-4 (torch's
    own default is 1e-2)."""
    return torch.optim.AdamW(lora_parameters(lora), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def prepare_train(params):
    """Training mode: every QuantLinear of the backbone, LoRA bases
    included, carries its int8 requantized W^T (QuantLinear.
    prepare_backward), so that dx runs on the int8 product
    (qlora.py:141-165)."""

    def prep(lin):
        if isinstance(lin, LoraLinear) and isinstance(lin.base, QuantLinear):
            return LoraLinear(lin.base.prepare_backward(), lin.lora_A,
                              lin.lora_B, lin.alpha, lin.dropout)
        if isinstance(lin, QuantLinear):
            return lin.prepare_backward()
        return lin

    out = dict(params)
    out["layers"] = [{k: prep(v) for k, v in layer.items()}
                     for layer in params["layers"]]
    if "lm_head" in out:
        out["lm_head"] = prep(out["lm_head"])
    return out


def qlora_loss_fn(lora, params, tokens, cfg):
    """The causal-LM loss with the adapters ``lora`` injected into the
    frozen ``params`` (qlora.py:168-175)."""
    return llama_loss(inject_lora(params, lora), tokens, cfg)


def qlora_train_step(lora, optimizer, params, tokens, cfg):
    """One optimiser step on the adapters (qlora.py:178-183): the loss,
    its gradients (the adapters' only) and ``optimizer.step()``, which
    updates the adapters in place. ``optimizer`` is built over
    ``lora_parameters(lora)`` (``adamw``). Returns (lora, the loss)."""
    optimizer.zero_grad(set_to_none=True)
    loss = qlora_loss_fn(lora, params, tokens, cfg)
    loss.backward()
    optimizer.step()
    return lora, loss.detach()
