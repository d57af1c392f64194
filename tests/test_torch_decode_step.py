"""The port's non-scanned decode (prefill, decode_step, decode_chunk,
sample_logits, generate) against the JAX package, on the CPU.

The model is the layout ``generate`` serves: unfused wq/wk/wv/wo/w1/w2/w3
QuantLinears in the column-plane container (4-bit g128 RTN made by the
JAX package, impl "auto"), a bf16 head, head_dim 128 so that single-token
attention takes K5. JAX runs with ``FORCE_ATTN_KERNEL = True`` (its
decode attention kernel in interpret mode; on its own CPU branch it
would dequantize the cache to bf16, another arithmetic), the port with its
plain versions (K8 for the linears, K5 for the attention).

Tolerance: logits within ATOL 0.1, argmax equal where the top-2 margin
exceeds 2 * ATOL, as tests/test_torch_engine.py: bf16 activations round
differently when f32 sums are taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import decode as JD
from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.kv_cache import init_kv_cache as j_init
from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache

from test_torch_engine import jax_tree_to_numpy

torch.set_num_threads(1)

ATOL = 0.1
CFG = dict(dim=1024, n_heads=8, n_kv_heads=8, ffn_dim=512, max_seq_len=64)


@pytest.fixture(scope="module")
def model():
    cfg_j = JL.llama_tiny(**CFG)
    params = JL.init_llama_params(cfg_j, jax.random.PRNGKey(0))
    qparams = JL.quantize_llama_params(
        params, lambda p, lin: JQuant.from_dense(
            lin.w.astype(jnp.float32), bits=4, groupsize=128))
    tparams = params_from_numpy(jax_tree_to_numpy(qparams), "cpu")
    return cfg_j, qparams, TL.llama_tiny(**CFG), tparams


@pytest.fixture
def attn_kernel(monkeypatch):
    monkeypatch.setattr(JD, "FORCE_ATTN_KERNEL", True)


def _prompt(B=2, S=8, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _check_rows(rows):
    for lj, lt in rows:
        np.testing.assert_allclose(lt, lj, atol=ATOL)
        top2 = np.sort(lj, -1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 2 * ATOL
        np.testing.assert_array_equal(lt.argmax(-1)[decisive],
                                      lj.argmax(-1)[decisive])


@pytest.mark.parametrize("kv_quantized", [True, False])
def test_teacher_forced_decode_step_matches_jax(model, attn_kernel,
                                                kv_quantized):
    """prefill, then four decode_steps fed the reference's greedy tokens,
    over an int8 and a bf16 cache; the port's attention is K5."""
    cfg_j, qparams, cfg_t, tparams = model
    prompt = _prompt()
    jc = j_init(cfg_j, 2, 32, kv_quantized)
    tc = init_kv_cache(cfg_t, 2, 32, device="cpu",
                       quantized=kv_quantized)
    jl, jc = JD.prefill(qparams, jnp.asarray(prompt), jc, cfg_j)
    tl, tc = TD.prefill(tparams, torch.from_numpy(prompt).long(), tc, cfg_t)
    rows = [(np.asarray(jl, np.float32), tl.numpy())]
    for _ in range(4):
        tok = rows[-1][0].argmax(-1).astype(np.int32)
        jl, jc = JD.decode_step(qparams, jnp.asarray(tok), jc, cfg_j)
        tl, tc = TD.decode_step(tparams, torch.from_numpy(tok), tc, cfg_t)
        rows.append((np.asarray(jl, np.float32), tl.numpy()))
    assert tc.length.tolist() == [12, 12]
    assert tc.quantized == ("int8" if kv_quantized else False)
    _check_rows(rows)


def test_decode_step_takes_k5_and_k8(model, monkeypatch):
    """A single-token step runs K5 once per layer and every linear through
    quant_matmul (impl "auto"): counted through the plain versions."""
    _, _, cfg_t, tparams = model
    from sparsebit_tpu_torch.ops import attention as TA
    from sparsebit_tpu_torch.ops import quant_matmul as TQ

    calls = {"attn": 0, "k8": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TA, "_decode_attn_plain",
                        count("attn", TA._decode_attn_plain))
    monkeypatch.setattr(TQ, "_qmm_planes_plain",
                        count("k8", TQ._qmm_planes_plain))
    tc = init_kv_cache(cfg_t, 2, 16, device="cpu")
    tc.length = torch.tensor([3, 9], dtype=torch.int32)
    TD.decode_step(tparams, torch.tensor([1, 2], dtype=torch.int32), tc,
                   cfg_t)
    assert calls == {"attn": cfg_t.n_layers, "k8": 7 * cfg_t.n_layers}


def _jax_greedy(qparams, cfg_j, prompt, n):
    """JAX's generate loop, with the logits it decided on."""
    cache = j_init(cfg_j, prompt.shape[0], prompt.shape[1] + n, True)
    logits, cache = JD.prefill(qparams, jnp.asarray(prompt), cache, cfg_j)
    toks, rows = [], []
    for _ in range(n):
        lg = np.asarray(logits, np.float32)
        rows.append(lg)
        tok = lg.argmax(-1).astype(np.int32)
        toks.append(tok)
        logits, cache = JD.decode_step(qparams, jnp.asarray(tok), cache,
                                       cfg_j)
    return np.stack(toks, 1), rows


def test_generate_greedy_matches_jax(model, attn_kernel):
    """Greedy tokens of generate equal JAX's up to each row's first step
    whose top-2 margin is within twice the port's logit error along the
    same tokens (the noise that may break a near tie; after it the
    sequences may part). JAX's generate gives its loop's tokens."""
    cfg_j, qparams, cfg_t, tparams = model
    prompt = _prompt(seed=5)
    n = 6
    ref, rows = _jax_greedy(qparams, cfg_j, prompt, n)
    np.testing.assert_array_equal(
        np.asarray(JD.generate(qparams, jnp.asarray(prompt), cfg_j,
                               max_new_tokens=n)), ref)
    tc = init_kv_cache(cfg_t, 2, prompt.shape[1] + n, device="cpu")
    lt, tc = TD.prefill(tparams, torch.from_numpy(prompt).long(), tc, cfg_t)
    err = np.abs(lt.numpy() - rows[0]).max()
    for t in range(n - 1):
        lt, tc = TD.decode_step(tparams, torch.from_numpy(ref[:, t]), tc,
                                cfg_t)
        err = max(err, np.abs(lt.numpy() - rows[t + 1]).max())
    assert err <= ATOL
    out = TD.generate(tparams, prompt, cfg_t, max_new_tokens=n,
                      device="cpu").numpy()
    assert out.shape == (2, n) and out.dtype == np.int32
    checked = 0
    for b in range(2):
        for t in range(n):
            top2 = np.sort(rows[t][b])[-2:]
            if top2[1] - top2[0] <= 2 * err:
                break
            assert out[b, t] == ref[b, t], (b, t)
            checked += 1
    assert checked >= 8


@pytest.mark.parametrize("top_k,top_p", [(40, 1.0), (0, 0.9), (40, 0.9)])
def test_sample_logits_keeps_jax_set(monkeypatch, top_k, top_p):
    """The tokens sample_logits may draw (finite filtered logits) are the
    ones JAX's sample_logits may draw, captured at its categorical."""
    logits = np.random.default_rng(top_k).standard_normal((3, 512)).astype(
        np.float32) * 3
    seen = {}

    def categorical(key, scaled, axis=-1):
        seen["scaled"] = np.asarray(scaled)
        return jnp.argmax(scaled, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    with jax.disable_jit():
        JD.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), 0.8,
                         top_k, top_p)
    kept = TD.filter_logits(torch.from_numpy(logits), 0.8, top_k, top_p)
    np.testing.assert_array_equal(np.isfinite(kept.numpy()),
                                  np.isfinite(seen["scaled"]))
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = TD.sample_logits(torch.from_numpy(logits), g, 0.8, top_k,
                               top_p)
        assert np.isfinite(kept.numpy()[np.arange(3), tok.numpy()]).all()


def test_generate_stops_at_eos(model):
    """A row that emitted eos_id repeats it; the loop stops once every row
    has (decode.py:1070-1079)."""
    _, _, cfg_t, tparams = model
    prompt = _prompt(seed=4)
    free = TD.generate(tparams, prompt, cfg_t, max_new_tokens=6,
                       device="cpu").numpy()
    eos = int(free[0, 1])
    out = TD.generate(tparams, prompt, cfg_t, max_new_tokens=6, eos_id=eos,
                      device="cpu").numpy()
    for b in range(2):
        hits = np.nonzero(free[b] == eos)[0]
        first = hits[0] if len(hits) else None
        if first is None:
            np.testing.assert_array_equal(out[b], free[b, :out.shape[1]])
        else:
            np.testing.assert_array_equal(out[b, :first + 1],
                                          free[b, :first + 1])
            assert (out[b, first:] == eos).all()
    ends = [np.nonzero(free[b] == eos)[0] for b in range(2)]
    if all(len(e) for e in ends):
        assert out.shape[1] == max(e[0] for e in ends) + 1
    one = TD.generate(tparams, prompt[:1], cfg_t, max_new_tokens=6,
                      eos_id=eos, device="cpu").numpy()
    assert one.shape == (1, 2) and one[0, -1] == eos


def test_decode_chunk_is_the_decode_step_loop(model):
    """decode_chunk at temperature 0 emits decode_step's greedy tokens and
    leaves the same cache; decode_tokens likewise."""
    _, _, cfg_t, tparams = model
    tok0 = torch.tensor([3, 77], dtype=torch.int32)
    caches = []
    for _ in range(3):
        c = init_kv_cache(cfg_t, 2, 16, device="cpu")
        c.length = torch.tensor([0, 5], dtype=torch.int32)
        caches.append(c)
    toks, c0 = TD.decode_chunk(tparams, tok0, caches[0], torch.zeros(2),
                               torch.Generator(), cfg_t, 3)
    greedy, c2 = TD.decode_tokens(tparams, tok0, caches[2], cfg_t, 3)
    tok, ref = tok0, []
    for _ in range(3):
        logits, c1 = TD.decode_step(tparams, tok, caches[1], cfg_t)
        tok = logits.argmax(-1).to(torch.int32)
        ref.append(tok)
    ref = torch.stack(ref, 1)
    assert torch.equal(toks, ref) and torch.equal(greedy, ref)
    assert c0.length.tolist() == c1.length.tolist() == [3, 8]
    assert torch.equal(c0.k, c1.k) and torch.equal(c0.k_scale, c1.k_scale)


def test_generate_needs_cuda_unless_cpu_is_asked(model, monkeypatch):
    _, _, cfg_t, tparams = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TD.generate(tparams, _prompt(), cfg_t, max_new_tokens=2)
