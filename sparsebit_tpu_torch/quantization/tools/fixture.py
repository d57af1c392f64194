"""The graph regime's accuracy fixture, CNN part (port of the CNN part of
``sparsebit_tpu/quantization/tools/fixture.py``): a tiny CNN trained on a
synthetic shifted-template classification task, so that top-1 claims
about the PTQ flow are testable without a dataset. It runs the harness an
ImageNet run uses (reference
examples/post_training_quantization/imagenet1k/basecase/main.py:152-229):
model -> QuantModel -> calibration forwards -> calc_qparams -> fake-quant
eval.

The data are made with numpy exactly as the JAX package makes them, so
both packages see the same images. Training is the port's own: a CPU
``torch.Generator`` seeds the weights and draws the batches, and
``torch.optim.Adam(lr)`` steps them.
"""

import numpy as np
import torch
import torch.nn.functional as TF

import sparsebit_tpu_torch.nn.modules as nn
from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.quantization.quant_config import parse_qconfig


class FixtureCNN(nn.Module):
    """conv-relu-conv-relu-pool-linear: small enough to train in seconds,
    deep enough for the conv, activation, pool and linear QModules and
    per-channel weight quantization."""

    def __init__(self, n_classes=10, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1, **kw)
        self.relu1 = nn.ReLU()
        self.conv2 = nn.Conv2d(16, 32, 3, stride=2, padding=1, **kw)
        self.relu2 = nn.ReLU()
        self.pool = nn.AdaptiveAvgPool2d(1)
        self.flat = nn.Flatten()
        self.fc = nn.Linear(32, n_classes, **kw)

    def forward(self, x):
        x = self.relu1(self.conv1(x))
        x = self.relu2(self.conv2(x))
        return self.fc(self.flat(self.pool(x)))


def make_shifted_template_data(n, n_classes=10, size=16, noise=0.6, seed=0,
                               template_seed=1234, shift_multiple=1):
    """Class k = a fixed random template, circularly shifted by a random
    offset a sample, plus Gaussian noise (numpy; the JAX package's
    arrays). The shift makes the task translation-invariant, so it needs
    the conv path it certifies; train and eval splits (different
    ``seed``) share the templates."""
    rng_t = np.random.default_rng(template_seed)
    templates = rng_t.normal(size=(n_classes, size, size, 3)).astype(
        np.float32)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    x = templates[y].copy()
    n_shift = size // shift_multiple
    for i in range(n):
        dy, dx = rng.integers(0, n_shift, size=2) * shift_multiple
        x[i] = np.roll(x[i], (int(dy), int(dx)), axis=(0, 1))
    x += rng.normal(scale=noise, size=x.shape).astype(np.float32)
    return x, y.astype(np.int64)


def _ptq_cfg(w_bit=8, a_bit=8):
    return parse_qconfig({
        "BACKEND": "virtual",
        "W": {"QSCHEME": "per-channel-symmetric",
              "QUANTIZER": {"TYPE": "uniform", "BIT": w_bit},
              "OBSERVER": {"TYPE": "MINMAX"}},
        "A": {"QSCHEME": "per-tensor-affine",
              "QUANTIZER": {"TYPE": "uniform", "BIT": a_bit},
              "OBSERVER": {"TYPE": "MINMAX", "LAYOUT": "NHWC"}},
    })


@torch.no_grad()
def _accuracy(model_fn, x, y, device, batch=256):
    correct = 0
    for i in range(0, len(x), batch):
        logits = model_fn(torch.from_numpy(x[i:i + batch]).to(device))
        correct += int((logits.argmax(-1).cpu()
                        == torch.from_numpy(y[i:i + batch])).sum())
    return correct / len(x)


def ptq_sweep(qmodel, x_tr, x_ev, y_ev, bit_configs, device, batch=128):
    """Calibrate on the first 512 training images and evaluate at each
    (w_bit, a_bit), re-deriving qparams after ``set_bit`` (the reference
    flow's per-quantizer hook, QAT basecase main.py:236-239)."""
    results = {}
    for w_bit, a_bit in bit_configs:
        for _, op in qmodel.qmodules():
            if op.weight_quantizer is not None:
                op.weight_quantizer.set_bit(w_bit)
            if op.input_quantizer is not None:
                op.input_quantizer.set_bit(a_bit)
        qmodel.prepare_calibration()
        for i in range(0, 512, batch):
            qmodel(torch.from_numpy(x_tr[i:i + batch]).to(device))
        qmodel.calc_qparams()
        qmodel.set_quant(w_quant=True, a_quant=True)
        results["acc_w{}a{}".format(w_bit, a_bit)] = _accuracy(
            qmodel, x_ev, y_ev, device)
        qmodel.set_quant(w_quant=False, a_quant=False)
    return results


def run_cnn_fixture(steps=300, n_train=4096, n_eval=2048, batch=128, lr=3e-3,
                    bit_configs=((8, 8), (4, 8)), seed=0, verbose=False, *,
                    device=None):
    """Train the float model, calibrate, PTQ at each (w_bit, a_bit).
    Returns the dict recorded as the accuracy artifact."""
    from sparsebit_tpu_torch.quantization.quant_model import QuantModel

    device = resolve_device(device)
    x_tr, y_tr = make_shifted_template_data(n_train, seed=seed)
    x_ev, y_ev = make_shifted_template_data(n_eval, seed=seed + 1)
    model = FixtureCNN(generator=torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    qmodel = QuantModel(model, _ptq_cfg(),
                        (torch.from_numpy(x_tr[:batch]).to(device),))
    qmodel.set_quant(w_quant=False, a_quant=False)

    opt = torch.optim.Adam(list(model.parameters()), lr=lr)
    gen = torch.Generator().manual_seed(seed + 2)
    x_all = torch.from_numpy(x_tr).to(device)
    y_all = torch.from_numpy(y_tr).to(device)
    for i in range(steps):
        idx = torch.randint(0, n_train, (batch,), generator=gen).to(device)
        loss = TF.cross_entropy(qmodel(x_all[idx]), y_all[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if verbose and (i + 1) % 100 == 0:
            print("train step {}: loss {:.4f}".format(i + 1, loss.item()))

    results = {
        "config": "fixture-cnn 16x16x3, 10-class shifted templates",
        "train_steps": steps,
        "n_train": n_train,
        "n_eval": n_eval,
        "acc_float": _accuracy(qmodel, x_ev, y_ev, device),
    }
    results.update(ptq_sweep(qmodel, x_tr, x_ev, y_ev, bit_configs, device,
                             batch))
    if verbose:
        print(results)
    return results
