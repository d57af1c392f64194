"""GPTQ solver: Hessian-damped blockwise weight quantization (port of
``sparsebit_tpu/llm/gptq.py``; the reference's utils/gptq.py:17-174).

- ``HessianAccumulator`` streams H = 2/n sum x x^T and mean(x) over
  calibration batches, rows counted as the JAX package counts them.
- ``_hinv_cholesky`` damps H (dead columns get a unit diagonal) and
  returns the upper factor U of its inverse, Hinv = U^T U.
- ``_gptq_core`` is the reference's blockwise column loop in eager
  PyTorch on the caller's device: inside a 128-column panel each column
  is quantized and its error spread over the panel's later columns by a
  rank-1 update; the panel's errors then reach the trailing columns as one
  product. It is no Pallas kernel in JAX, so it has no hand-written
  kernel here. The weight is held as (K, N) so that a column of the
  reference's (N, K) loop is one contiguous row.
- ``gptq_quantize`` adds act-order (columns in decreasing diag(H)) and
  bias correction; ``gptq_quantize_mixed`` the mixed-precision candidates.

Everything is IEEE f32: a bf16 Hessian loses the Cholesky, and so do TF32
products on the card. PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32 = False``) gives f32 products;
a caller that turned TF32 on gets another result.
"""

import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm.quant import LLMQuantizer


class HessianAccumulator:
    """Streaming H = 2/n sum x x^T and mean(x) over every row fed so far
    (gptq.py:27-45): a batch of b rows after n rows scales H by n/(n+b)
    and adds 2/(n+b) X^T X. H and mean_x are f32 on ``device`` (default
    the card)."""

    def __init__(self, K, *, device=None):
        device = resolve_device(device)
        self.H = torch.zeros((K, K), dtype=torch.float32, device=device)
        self.mean_x = torch.zeros((K,), dtype=torch.float32, device=device)
        self.nsamples = 0

    def add_batch(self, x):
        """x: (..., K) activations feeding the linear."""
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        b = x2.shape[0]
        n = self.nsamples
        self.H = self.H * (n / (n + b)) + (2.0 / (n + b)) * _xtx(x2)
        self.mean_x = self.mean_x * (n / (n + b)) + (b / (n + b)) * \
            x2.mean(dim=0)
        self.nsamples = n + b


def _xtx(x):
    return x.t() @ x


def _hinv_cholesky(H, percdamp):
    """Damped inverse-Hessian upper Cholesky factor (gptq.py:52-65): a
    dead column (diag 0) gets diag 1, then every diagonal entry the damp
    percdamp * mean(diag). Returns (U, dead) with Hinv = U^T U."""
    H = H.clone()
    diag = H.diagonal()
    dead = diag == 0
    diag.add_(dead.to(H.dtype))
    diag.add_(percdamp * diag.mean())
    L = torch.linalg.cholesky(H)
    Hinv = torch.cholesky_inverse(L)
    return torch.linalg.cholesky(Hinv, upper=True), dead


def _gptq_core(W, U, dead, bits, groupsize, blocksize, sym):
    """W: (K, N) f32, row k the reference's column k (updated in place);
    U: (K, K) upper Cholesky factor of Hinv.

    Returns (codes uint8 (K, N), scales (G, N), zeros (G, N), Wq (K, N),
    total squared error as a 0-d tensor). A group's qparams are found when
    the loop enters it, from the live, error-compensated rows
    (gptq.py:115-119 of the reference)."""
    K, N = W.shape
    gs = groupsize if groupsize > 0 else K
    quantizer = LLMQuantizer(bits=bits, sym=sym)
    W.masked_fill_(dead[:, None], 0.0)
    Q = torch.empty_like(W)
    codes = torch.empty((K, N), dtype=torch.uint8, device=W.device)
    scales = torch.empty((K // gs, N), dtype=torch.float32, device=W.device)
    zeros = torch.empty_like(scales)
    err_total = torch.zeros((), dtype=torch.float32, device=W.device)
    for i1 in range(0, K, blocksize):
        i2 = i1 + blocksize
        Wb = W[i1:i2]  # (BS, N) view: the panel, updated in place
        d = U[i1:i2, i1:i2].diagonal()
        Un = U[i1:i2, i1:] / d[:, None]  # the panel's rows of U / diag
        Errb = torch.empty_like(Wb)
        for ci in range(blocksize):
            col = i1 + ci
            if col % gs == 0:  # entering a group: qparams of the live rows
                g = col // gs
                Wg = Wb[ci:ci + gs] if gs <= blocksize else W[col:col + gs]
                s, z = quantizer.find_params(Wg)
                scales[g], zeros[g] = s[0], z[0]
                s, z = scales[g], zeros[g]
            w = Wb[ci]
            c = torch.clamp(torch.round(w / s) + z, 0, quantizer.qmax)
            q = (c - z) * s
            e = (w - q) / d[ci]
            Q[col] = q
            codes[col] = c
            Errb[ci] = e
            # spread the error over the panel's later rows
            Wb[ci + 1:].addr_(Un[ci, ci + 1:blocksize], e, alpha=-1)
        err_total += (Errb * Errb).sum()
        # trailing update: W[i2:] -= (U[i1:i2, i2:] / diag)^T @ Errb
        if i2 < K:
            W[i2:].addmm_(Un[:, blocksize:].t(), Errb, alpha=-1)
    return codes, scales, zeros, Q, err_total


def gptq_quantize(w, H, bits=4, groupsize=-1, sym=False, percdamp=0.01,
                  blocksize=128, mean_x=None, bias=None, act_order=False):
    """Quantize one (K, N) weight against Hessian H (K, K), both on one
    device (gptq.py:187-248).

    Returns a dict: codes (K, N) uint8, scales/zeros (G, N), the
    fake-quant weight wq (K, N), the per-weight mean loss, the bits, perm,
    and the bias-corrected bias (bias + mean_x @ (w - wq)) when ``bias``
    and ``mean_x`` are given.

    ``act_order``: quantize rows in decreasing diag(H) order (a stable
    sort, so dead rows keep their order, as jnp.argsort). codes and scales
    stay in that PERMUTED order with contiguous groups; ``perm`` is
    applied to activations at matmul time (x[..., perm]); wq is returned
    in the original order."""
    K, N = w.shape
    w_orig = w
    perm = None
    if act_order:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        H = H[perm][:, perm]
        w = w[perm]
    bs = min(blocksize, K)
    gs_eff = groupsize if groupsize > 0 else K
    if K % bs or K % gs_eff or (gs_eff % bs and bs % gs_eff):
        raise ValueError(
            "K={} needs whole blocks of {} and groups of {} that nest".format(
                K, bs, gs_eff))
    U, dead = _hinv_cholesky(H.to(torch.float32), percdamp)
    codes, scales, zeros, Q, err = _gptq_core(
        w.to(torch.float32).clone(), U, dead, bits, groupsize, bs, sym)
    if act_order:
        Q = torch.empty_like(Q).index_copy_(0, perm, Q)
    out = {"codes": codes, "scales": scales, "zeros": zeros, "wq": Q,
           "loss": float(err) / (K * N), "bits": bits, "perm": perm}
    if bias is not None and mean_x is not None:
        dw = w_orig.to(torch.float32) - Q
        out["bias"] = bias + mean_x.to(torch.float32) @ dw
    return out


def gptq_quantize_mixed(w, H, candidate_bits=(4,), loss_threshold=1e-3,
                        **kw):
    """Mixed-precision candidate loop (gptq.py:251-261): try bits in
    order, keep the first whose mean loss < threshold (else the last)."""
    result = None
    for bits in candidate_bits:
        result = gptq_quantize(w, H, bits=bits, **kw)
        if result["loss"] < loss_threshold:
            return result
    return result
