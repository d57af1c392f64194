"""The graph regime's accuracy fixtures (port of
``sparsebit_tpu/quantization/tools/fixture.py``): tiny models trained on
synthetic tasks, so that top-1 claims about the PTQ and QAT flows are
testable without a dataset. They run the harness an ImageNet run uses
(reference examples/post_training_quantization/imagenet1k/basecase/
main.py:152-229): model -> QuantModel -> calibration forwards ->
calc_qparams -> fake-quant eval.

- CNN: a conv net on shifted templates (``run_cnn_fixture``);
- DeiT regime: a tiny ViT on patch-shifted templates, LayerNorm and
  softmax left in float, MSE observers (``run_vit_fixture``);
- CoLA regime: the zoo's BertModel on Markov-chain "grammaticality",
  percentile activation observers (``run_bert_fixture``);
- QAT-DeiT regime: the tiny ViT at LSQ 4w4a trained through the
  quantized attention path (``run_vit_qat_fixture``).

The data are made with numpy exactly as the JAX package makes them, so
both packages see the same inputs. Training is the port's own: a CPU
``torch.Generator`` seeds the weights and draws the batches, and
``torch.optim.Adam`` steps them (optax's cosine decay becomes a
``LambdaLR`` with the same value at each step).
"""

import math


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


def ptq_sweep(qmodel, x_tr, x_ev, y_ev, bit_configs, device, batch=128,
              eval_batch=256):
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
            qmodel, x_ev, y_ev, device, eval_batch)
        qmodel.set_quant(w_quant=False, a_quant=False)
    return results


def _fit(qmodel, params, x_all, y_all, steps, batch, lr, gen, verbose,
         what="train"):
    """``steps`` Adam steps of the float model on batches drawn from
    ``gen``."""
    opt = torch.optim.Adam(params, lr=lr)
    n = len(x_all)
    for i in range(steps):
        idx = torch.randint(0, n, (batch,), generator=gen).to(x_all.device)
        loss = TF.cross_entropy(qmodel(x_all[idx]), y_all[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if verbose and (i + 1) % 100 == 0:
            print("{} step {}: loss {:.4f}".format(what, i + 1, loss.item()))


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

    gen = torch.Generator().manual_seed(seed + 2)
    _fit(qmodel, list(model.parameters()), torch.from_numpy(x_tr).to(device),
         torch.from_numpy(y_tr).to(device), steps, batch, lr, gen, verbose)

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


# ---- transformer regimes (DeiT / CoLA), NLC, LayerNorm and softmax in float


def _transformer_cfg(w_bit=8, a_bit=8, w_observer="MSE", a_observer="MSE"):
    """DeiT regime (defaults): MSE observers, NLC layout, LayerNorm and
    softmax left in float (examples/post_training_quantization/
    imagenet1k_deit/qconfig.yaml). The CoLA regime passes
    w_observer="MINMAX", a_observer="PERCENTILE" (ALPHA 0.001)."""
    return parse_qconfig({
        "BACKEND": "virtual",
        "W": {"QSCHEME": "per-channel-symmetric",
              "QUANTIZER": {"TYPE": "uniform", "BIT": w_bit},
              "OBSERVER": {"TYPE": w_observer}},
        "A": {"QSCHEME": "per-tensor-affine",
              "QUANTIZER": {"TYPE": "uniform", "BIT": a_bit},
              "OBSERVER": {"TYPE": a_observer, "LAYOUT": "NLC",
                           "PERCENTILE": {"ALPHA": 0.001}},
              "SPECIFIC": [{
                  "*norm*": ["QUANTIZER.DISABLE", "True"],
                  "*softmax*": ["QUANTIZER.DISABLE", "True"],
              }]},
    })


def _train_and_sweep(qmodel, model, x_tr, y_tr, x_ev, y_ev, steps, batch, lr,
                     seed, bit_configs, config_name, verbose, device):
    """Train the float model, then the PTQ sweep (the CNN fixture's loop,
    shared by the transformer fixtures). Transformer graphs bake the batch
    into their reshapes when traced, so evaluation runs at the traced
    batch (``n_eval`` a multiple of it)."""
    gen = torch.Generator().manual_seed(seed + 2)
    _fit(qmodel, list(model.parameters()), torch.from_numpy(x_tr).to(device),
         torch.from_numpy(y_tr).to(device), steps, batch, lr, gen, verbose)
    assert len(x_ev) % batch == 0, (len(x_ev), batch)
    results = {
        "config": config_name,
        "train_steps": steps,
        "n_train": len(x_tr),
        "n_eval": len(x_ev),
        "acc_float": _accuracy(qmodel, x_ev, y_ev, device, batch),
    }
    if verbose:
        print("float acc:", results["acc_float"])
    results.update(ptq_sweep(qmodel, x_tr, x_ev, y_ev, bit_configs, device,
                             batch, eval_batch=batch))
    if verbose:
        print(results)
    return results


def _fixture_vit(seed, device):
    from sparsebit_tpu_torch.models.vit import VisionTransformer

    model = VisionTransformer(
        img_size=16, patch_size=4, dim=48, depth=2, num_heads=2,
        num_classes=10, generator=torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _patch_shifted(n_train, n_eval, seed):
    """The shifted-template task with patch-aligned shifts (the patch set
    is permuted, its contents kept: attention can pool it) and noise 2.2,
    so that float top-1 stays off the ceiling and the w8a8 / w4a8 deltas
    are measurable."""
    return (make_shifted_template_data(n_train, size=16, seed=seed,
                                       shift_multiple=4, noise=2.2),
            make_shifted_template_data(n_eval, size=16, seed=seed + 1,
                                       shift_multiple=4, noise=2.2))


def run_vit_fixture(steps=300, n_train=4096, n_eval=1024, batch=128, lr=1e-3,
                    bit_configs=((8, 8), (4, 8)), seed=0, verbose=False, *,
                    device=None):
    """DeiT-regime gate: a tiny VisionTransformer (patch conv -> 2 MHSA
    blocks with F.matmul / softmax / LayerNorm on the NLC path -> cls
    head) on the patch-shifted template task."""
    from sparsebit_tpu_torch.quantization.quant_model import QuantModel

    device = resolve_device(device)
    (x_tr, y_tr), (x_ev, y_ev) = _patch_shifted(n_train, n_eval, seed)
    model = _fixture_vit(seed, device)
    qmodel = QuantModel(model, _transformer_cfg(),
                        (torch.from_numpy(x_tr[:batch]).to(device),))
    qmodel.set_quant(w_quant=False, a_quant=False)
    return _train_and_sweep(
        qmodel, model, x_tr, y_tr, x_ev, y_ev, steps, batch, lr, seed,
        bit_configs,
        "fixture-vit 16x16x3/p4 d48 L2, 10-class patch-shifted templates",
        verbose, device)


def make_markov_lm_data(n, seqlen=16, vocab=64, n_classes=2, seed=0,
                        chain_seed=1234, sharpness=8.0):
    """CoLA-regime synthetic "grammaticality" (numpy; the JAX package's
    arrays): class k = a fixed random Markov chain over the vocabulary
    (peaked Dirichlet rows), a sample = a walk of ``seqlen`` tokens from
    it. Telling the chains apart needs bigram evidence, which attention
    must aggregate (their unigram marginals are near-identical)."""
    rng_c = np.random.default_rng(chain_seed)
    chains = rng_c.dirichlet(np.full(vocab, 1.0 / sharpness),
                             size=(n_classes, vocab))
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    x = np.zeros((n, seqlen), np.int32)
    for i in range(n):
        t = chains[y[i]]
        tok = rng.integers(0, vocab)
        for j in range(seqlen):
            x[i, j] = tok
            tok = rng.choice(vocab, p=t[tok])
    return x, y.astype(np.int64)


def run_bert_fixture(steps=400, n_train=4096, n_eval=1024, batch=128, lr=1e-3,
                     bit_configs=((8, 8), (4, 8)), seed=0, verbose=False, *,
                     device=None):
    """CoLA-regime gate: the zoo's BertModel (embeddings, 2 encoder layers,
    pooled cls head) on Markov-chain classification, with percentile
    activation observers as the reference's CoLA qconfig."""
    from sparsebit_tpu_torch.models.bert import BertModel
    from sparsebit_tpu_torch.quantization.quant_model import QuantModel

    device = resolve_device(device)
    x_tr, y_tr = make_markov_lm_data(n_train, seed=seed)
    x_ev, y_ev = make_markov_lm_data(n_eval, seed=seed + 1)
    model = BertModel(vocab_size=64, dim=48, depth=2, num_heads=2, ffn_dim=96,
                      num_classes=2,
                      generator=torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    qmodel = QuantModel(
        model, _transformer_cfg(w_observer="MINMAX", a_observer="PERCENTILE"),
        (torch.from_numpy(x_tr[:batch]).to(device),))
    qmodel.set_quant(w_quant=False, a_quant=False)
    return _train_and_sweep(
        qmodel, model, x_tr, y_tr, x_ev, y_ev, steps, batch, lr, seed,
        bit_configs, "fixture-bert vocab64 d48 L2, 2-chain Markov "
        "grammaticality", verbose, device)


def cosine_decay(steps, alpha):
    """optax.cosine_decay_schedule's factor at step t: (1 - alpha) * (1 +
    cos(pi * min(t, steps) / steps)) / 2 + alpha."""
    return lambda t: (1 - alpha) * 0.5 * (
        1 + math.cos(math.pi * min(t, steps) / steps)) + alpha


def run_vit_qat_fixture(steps=150, qat_steps=800, n_train=2048, n_eval=512,
                        batch=128, lr=1e-3, qat_lr=5e-4, qat_schedule="cosine",
                        seed=0, verbose=False, *, device=None):
    """QAT-DeiT-regime gate: the fixture ViT at LSQ 4w4a (low enough that
    plain PTQ visibly hurts), trained through the quantizers so that LSQ
    scales learn on the quantized attention path (QMatmul and softmax
    inputs), as examples/quantization_aware_training/imagenet1k_deit
    does. Returns acc_float, acc_ptq (quantizers on at LSQ's
    initialisation, the calibrated starting point) and acc_qat (after
    training); the gate: acc_qat >= 0.60 and >= acc_ptq + 0.25."""
    from sparsebit_tpu_torch.quantization.quant_model import QuantModel
    from sparsebit_tpu_torch.quantization.tools.qat import (
        commit_qat_params,
        cross_entropy,
        init_qat_state,
        make_qat_step,
    )

    device = resolve_device(device)
    (x_tr, y_tr), (x_ev, y_ev) = _patch_shifted(n_train, n_eval, seed)
    model = _fixture_vit(seed, device)
    cfg = parse_qconfig({
        "BACKEND": "virtual",
        "W": {"QSCHEME": "per-channel-symmetric",
              "QUANTIZER": {"TYPE": "lsq", "BIT": 4},
              "OBSERVER": {"TYPE": "MINMAX"}},
        "A": {"QSCHEME": "per-tensor-affine",
              "QUANTIZER": {"TYPE": "lsq", "BIT": 4},
              "OBSERVER": {"TYPE": "MINMAX", "LAYOUT": "NLC"},
              "SPECIFIC": [{
                  "*norm*": ["QUANTIZER.DISABLE", "True"],
                  "*softmax*": ["QUANTIZER.DISABLE", "True"],
              }]},
    })
    x_all = torch.from_numpy(x_tr).to(device)
    y_all = torch.from_numpy(y_tr).to(device)
    qmodel = QuantModel(model, cfg, (x_all[:batch],))
    qmodel.set_quant(w_quant=False, a_quant=False)

    gen = torch.Generator().manual_seed(seed + 2)
    _fit(qmodel, list(model.parameters()), x_all, y_all, steps, batch, lr,
         gen, verbose)
    acc_float = _accuracy(qmodel, x_ev, y_ev, device, batch)

    # calibrate and init_QAT: quantizers on at initialisation = PTQ
    qmodel.prepare_calibration()
    for i in range(0, 512, batch):
        qmodel(x_all[i:i + batch])
    qmodel.init_QAT()
    acc_ptq = _accuracy(qmodel, x_ev, y_ev, device, batch)

    # QAT: weights and LSQ scales through the fake-quant graph
    qmodel.train()
    trainable, opt = init_qat_state(
        qmodel, lambda ps: torch.optim.Adam(ps, lr=qat_lr))
    sched = (torch.optim.lr_scheduler.LambdaLR(
        opt, cosine_decay(qat_steps, 0.05)) if qat_schedule == "cosine"
        else None)
    step = make_qat_step(qmodel, cross_entropy, opt)
    for i in range(qat_steps):
        idx = torch.randint(0, n_train, (batch,), generator=gen).to(device)
        trainable, loss = step(trainable, x_all[idx], y_all[idx])
        if sched is not None:
            sched.step()
        if verbose and (i + 1) % 50 == 0:
            print("qat step {}: loss {:.4f}".format(i + 1, loss.item()))
    commit_qat_params(qmodel, trainable)
    qmodel.eval()
    acc_qat = _accuracy(qmodel, x_ev, y_ev, device, batch)
    return {
        "config": "fixture-vit-qat 16x16x3/p4 d48 L2, LSQ 4w4a",
        "train_steps": steps, "qat_steps": qat_steps,
        "n_train": n_train, "n_eval": len(x_ev),
        "acc_float": acc_float, "acc_ptq": acc_ptq, "acc_qat": acc_qat,
    }
