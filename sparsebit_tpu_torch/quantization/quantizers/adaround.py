"""AdaRound: learnable rounding through a rectified sigmoid, and the layer
reconstruction that trains it (port of
``sparsebit_tpu/quantization/quantizers/adaround.py``; reference:
sparsebit/quantization/quantizers/adaround.py:16-134: zeta / gamma
stretch 1.1 / -0.1, LinearTempDecay beta 20 -> 2 after a 0.2 warm-up,
Adam, reconstruction loss |.|^p summed over channels and averaged over
the rest, round loss weight 1e-3, 20k steps).

The reconstruction loss is the reference's ``lp_loss``, ``sum(1).mean()``
on NCHW: channels summed, samples and pixels averaged. The JAX package
sums every axis but the batch (adaround.py:95-97 there), which weakens
the round loss by H x W on a convolution; the port keeps the reference's
(reference fault R10 in ROADMAP.md). On a linear layer's (N, C) output
the two are one number.

``torch.optim.Adam(lr=1e-3)`` takes the place of optax's ``adam(1e-3)``
(the same betas (0.9, 0.999) and eps 1e-8 outside the square root). Each
step's batch is drawn without replacement from an explicit CPU
``torch.Generator(seed)``, so the card and the CPU see the same batches;
all are drawn before the first step.
"""

import torch

from sparsebit_tpu_torch.quantization.common import QuantTarget
from sparsebit_tpu_torch.quantization.quantizers import register_quantizer
from sparsebit_tpu_torch.quantization.quantizers.base import (
    Quantizer as BaseQuantizer,
    learnable,
)

ZETA, GAMMA = 1.1, -0.1


@register_quantizer
class Quantizer(BaseQuantizer):
    TYPE = "adaround"

    def __init__(self, config):
        super().__init__(config)
        assert self.qdesc.target == QuantTarget.WEIGHT, (
            "AdaRound only supports to quant weights")
        self.v = None

    def init_variables(self, x):
        with torch.no_grad():
            x_floor = torch.floor(x / self.scale)
            rest = (x / self.scale - x_floor).clamp(1e-4, 1 - 1e-4)
            self.v = learnable(
                -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0))

    def trainable_params(self):
        return {"v": self.v} if self.v is not None else {}

    @staticmethod
    def _soft_round(v):
        return (torch.sigmoid(v) * (ZETA - GAMMA) + GAMMA).clamp(0.0, 1.0)

    def _forward(self, x, scale, zero_point, params=None):
        v = params.get("v", self.v) if params else self.v
        x_floor = torch.floor(x / scale)
        if self.training and v is not None:
            x_q = x_floor + self._soft_round(v)
        elif v is not None:
            x_q = x_floor + (v >= 0).to(x.dtype)
        else:
            x_q = torch.round(x / scale)
        x_q = (x_q + zero_point).clamp(self.qdesc.qmin, self.qdesc.qmax)
        return (x_q - zero_point) * scale


def linear_temp_decay(step, max_steps, rel_start_step, start_beta, end_beta):
    start_step = rel_start_step * max_steps
    if step < start_step:
        return float(start_beta)
    ratio = (step - start_step) / (max_steps - start_step)
    return end_beta + (start_beta - end_beta) * max(0.0, 1.0 - ratio)


def reconstruction_loss(pred, target, p=2.0):
    """|pred - target|^p summed over the channel axis (the last: NHWC,
    NLC) and averaged over the others."""
    return ((pred - target).abs() ** p).sum(dim=-1).mean()


def reconstruct_qlayer(layer, inputs, outputs, batch_size=32,
                       max_steps=20000, beta_range=(20, 2), warmup=0.2,
                       p=2.0, round_loss_weight=1e-3, a_quant=False, seed=0):
    """Train the layer's AdaRound variable to reconstruct its float
    outputs. ``layer``: a QuantOpr whose weight_quantizer is adaround;
    ``inputs`` / ``outputs``: the stacked calibration tensors (N, ...)."""
    layer.eval()
    layer.set_quant(w_quant=True, a_quant=a_quant)
    wq = layer.weight_quantizer
    wq.init_variables(layer.get_weight().detach())
    wq.train(True)
    opt = torch.optim.Adam([wq.v], lr=1e-3)
    gen = torch.Generator().manual_seed(seed)
    n = inputs.shape[0]
    bs = min(batch_size, n)
    inputs, outputs = inputs.detach(), outputs.detach()
    # every step's batch drawn up front and copied once: a copy a step
    # from pageable memory would wait for the device each step
    batches = torch.stack([torch.randperm(n, generator=gen)[:bs]
                           for _ in range(max_steps)]).to(inputs.device)
    with torch.enable_grad():
        for step in range(max_steps):
            idx = batches[step]
            x, y = inputs[idx], outputs[idx]
            pred = layer.execute(x, params={"weight_quantizer.v": wq.v},
                                 training=True)
            rec_loss = reconstruction_loss(pred, y, p)
            loss = rec_loss
            if step >= warmup * max_steps:
                beta = linear_temp_decay(step, max_steps, warmup,
                                         beta_range[0], beta_range[1])
                round_vals = wq._soft_round(wq.v)
                round_loss = (1.0 - ((round_vals - 0.5) * 2.0).abs() ** beta
                              ).sum()
                loss = rec_loss + round_loss_weight * round_loss
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    wq.v = wq.v.detach().requires_grad_(False)
    wq.train(False)
    return layer
