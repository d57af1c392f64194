"""Perplexity evaluation (port of ``sparsebit_tpu/llm/eval.py``; the
reference's protocol, convert.py:176-259 llama_eval).

Token stream -> non-overlapping seqlen windows -> mean NLL -> exp. The
backbone runs causal_attention, so on the card every layer's attention
of a window is K10 (a seqlen-2048 window feeds it 2047 tokens: the port
takes a ragged S, fault R7).
"""

import numpy as np
import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm.llama import llama_backbone, llama_forward


def _nll(logits, targets):
    """Per-token f32 negative log-likelihood of targets under logits."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


def _window_nll(params, window, cfg):
    """(sum of the NLL, token count) of windows (B, S): the whole
    window's logits at once."""
    logits = llama_forward(params, window[:, :-1], cfg)
    nll = _nll(logits, window[:, 1:])
    return nll.sum(), nll.numel()


def _window_nll_chunked(params, window, cfg, chunk=256):
    """_window_nll with the lm_head and log-softmax applied in
    ``chunk``-token sequence slices, so the logits held at once are
    (B, chunk, V) f32 instead of (B, S, V) (32000-vocab x 2048 = 262 MB
    and its softmax temporaries). Each slice's sum is taken, then the
    slices' sums in order, as the reference's lax.map."""
    x = llama_backbone(params, window[:, :-1], cfg)  # (B, S-1, D)
    targets = window[:, 1:]
    B, S, _ = x.shape
    sums = [
        _nll(params["lm_head"](x[:, c0:c0 + chunk]),
             targets[:, c0:c0 + chunk]).sum()
        for c0 in range(0, S, chunk)
    ]
    return torch.stack(sums).sum(), B * S


def perplexity(params, token_stream, cfg, seqlen=2048, batch=1,
               verbose=False, head_chunk=None, *, device=None):
    """token_stream: 1-D int array. Returns the perplexity over its
    non-overlapping seqlen windows, ``batch`` windows a forward.
    head_chunk: sequence chunk of the lm_head/log-softmax (None = auto:
    256 at seqlen >= 512, the whole window below). The windows go to
    ``device`` (default the card), where params must lie."""
    dev = resolve_device(device)
    toks = np.asarray(token_stream).reshape(-1)
    n_win = len(toks) // seqlen
    assert n_win > 0, "stream shorter than one window"
    if head_chunk is None:
        head_chunk = 256 if seqlen >= 512 else 0
    total, count = 0.0, 0
    for i in range(0, n_win, batch):
        j = min(i + batch, n_win)
        win = torch.as_tensor(np.stack(
            [toks[k * seqlen:(k + 1) * seqlen] for k in range(i, j)]
        ).astype(np.int64), device=dev)
        if head_chunk:
            s, c = _window_nll_chunked(params, win, cfg, chunk=head_chunk)
        else:
            s, c = _window_nll(params, win, cfg)
        total += float(s)
        count += int(c)
        if verbose:
            print("ppl[{}/{}] = {:.4f}".format(j, n_win,
                                               np.exp(total / count)))
    return float(np.exp(total / count))
