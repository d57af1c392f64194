"""The port's non-scanned decode (prefill, decode_step, decode_chunk,
sample_logits, generate) against the JAX package, on the CPU.

The model is the layout ``generate`` serves: unfused wq/wk/wv/wo/w1/w2/w3
QuantLinears in the column-plane container (4-bit g128 RTN made by the
JAX package, impl "auto"), a bf16 head, head_dim 128 so that single-token
attention takes K5. JAX runs with ``FORCE_ATTN_KERNEL = True`` (its
decode attention kernel in interpret mode; on its own CPU branch it
would dequantize the cache to bf16, another arithmetic), the port with its
plain versions (K8 for the linears, K5 for the attention).

Faults E-H of the port, against the JAX package where they meet it:
- E: K5 takes every dtype an unquantized cache can have (bf16, f16, f32,
  as cfg.dtype says), so the route that sends such a cache to K5 agrees
  with the kernel's gate; an f32 model decodes over an f32 cache as the
  JAX package does with its decode attention kernel.
- F: the route predicate is the reference's (head_dim a multiple of 128,
  any GQA ratio); K5 and K2 take head_dim up to 512, so a head_dim of
  384 decodes through K5 as the JAX package does through its kernel, and
  past 512 the kernels' gates refuse the shape (on the card the wrappers
  raise; they never give way to the plain version there).
- G: prefill_cold_scanned writes the raw rows of a float cache (the paged
  engine's cold admission), as the JAX package does.
- H: init_kv_cache, DecodeEngine and PagedDecodeEngine take the
  reference's positional parameters; ``device`` is keyword-only.

At the end, the rest of llama.py and eval.py: llama_forward / llama_loss
on the masked route (both packages on the CPU) and on the flash route
(the port's _flash_ok patched to skip its device test, so its CPU tensors
take K10's plain version; the JAX package's patched to skip its backend
test, its flash kernel run under force_tpu_interpret_mode),
prefill_cold_scanned on the flash route, perplexity on both routes and
both head_chunk modes, and init_llama_params / fuse_llama_params /
llama_13b against the JAX package's.

Tolerance: logits within ATOL 0.1, argmax equal where the top-2 margin
exceeds 2 * ATOL, as tests/test_torch_engine.py: bf16 activations round
differently when f32 sums are taken in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparsebit_tpu.llm import decode as JD
from sparsebit_tpu.llm import eval as JE
from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.kv_cache import init_kv_cache as j_init
from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu.llm.serving import DecodeEngine as JEngine
from sparsebit_tpu.llm.serving import PagedDecodeEngine as JPaged
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import eval as TE
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.kv_cache import (
    init_kv_cache,
    init_paged_kv_cache,
)
from sparsebit_tpu_torch.llm.serving import DecodeEngine, PagedDecodeEngine
from sparsebit_tpu_torch.ops import attention as A

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


# ---- faults E-H ----------------------------------------------------------

def _fault_models(bits=4, fused=False, **cfg_kw):
    """A tiny LLaMA quantized by the JAX package (g64 RTN), and the same
    arrays in the port."""
    kw = dict(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=384, max_seq_len=64,
              n_layers=2)
    kw.update(cfg_kw)
    cfg_j = JL.llama_tiny(**kw)
    params = JL.init_llama_params(cfg_j, jax.random.PRNGKey(3))
    if fused:
        params = JL.fuse_llama_params(params)
    jq = JL.quantize_llama_params(params, lambda p, lin: JQuant.from_dense(
        lin.w.astype(jnp.float32), bits=bits, groupsize=64))
    return cfg_j, jq, TL.llama_tiny(**kw), params_from_numpy(
        jax_tree_to_numpy(jq), "cpu")


def _fault_prompt(B=2, S=6, seed=4):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _fault_decode_pair(models, kv_quantized, n=3):
    """prefill then n teacher-forced decode_steps on both sides (the JAX
    greedy tokens fed to both): the rows of logits."""
    cfg_j, jq, cfg_t, tq = models
    prompt = _fault_prompt()
    jc = j_init(cfg_j, 2, 16, kv_quantized)
    tc = init_kv_cache(cfg_t, 2, 16, kv_quantized, device="cpu")
    jl, jc = JD.prefill(jq, jnp.asarray(prompt), jc, cfg_j)
    tl, tc = TD.prefill(tq, torch.from_numpy(prompt), tc, cfg_t)
    rows = [(np.asarray(jl, np.float32), tl.float().numpy())]
    for _ in range(n):
        tok = rows[-1][0].argmax(-1).astype(np.int32)
        jl, jc = JD.decode_step(jq, jnp.asarray(tok), jc, cfg_j)
        tl, tc = TD.decode_step(tq, torch.from_numpy(tok), tc, cfg_t)
        rows.append((np.asarray(jl, np.float32), tl.float().numpy()))
    return rows, tc


# ---- E ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,quantized", [
    ("bfloat16", True), ("bfloat16", False), ("float16", False),
    ("float32", False)])
def test_k5_gate_agrees_with_the_route(dtype, quantized):
    """Fault E: for every cache init_kv_cache makes (int8, or the model's
    bf16, f16 or f32), the route sends a single-token step to K5 exactly
    when K5's gate takes the cache."""
    cfg = TL.llama_tiny(dim=256, n_heads=2, n_kv_heads=2, dtype=dtype)
    cache = init_kv_cache(cfg, 2, 16, quantized, device="cpu")
    q = torch.zeros((2, cfg.n_heads, cfg.head_dim))
    assert TD._use_attn_kernel(1, cache.quantized, cfg)
    A.k5_check(q, cache.k, cache.v, li=1)
    assert cache.k.dtype == (torch.int8 if quantized else cfg.torch_dtype)


def test_f32_cache_decode_matches_jax(monkeypatch):
    """Fault E: an f32 model (the reference fixture's dtype) over an f32
    cache: prefill and three decode_steps, the port's K5 (plain version
    here) against the JAX decode attention kernel in interpret mode."""
    monkeypatch.setattr(JD, "FORCE_ATTN_KERNEL", True)
    models = _fault_models(n_kv_heads=8, n_heads=8, dim=1024,
                           dtype="float32")
    seen = []
    real = A.decode_attention

    def spy(q, k, *a, **kw):
        seen.append(k.dtype)
        return real(q, k, *a, **kw)

    monkeypatch.setattr(TD, "decode_attention_stacked",
                        lambda q, k, v, ks, vs, li, ln: spy(q, k, v, ks, vs,
                                                            ln, li=li))
    rows, tc = _fault_decode_pair(models, False)
    _check_rows(rows)
    assert tc.k.dtype == torch.float32 and tc.k_scale is None
    assert seen and set(seen) == {torch.float32}


# ---- F ----------------------------------------------------------------------

@pytest.mark.parametrize("D,Hq,Hkv", [
    (128, 4, 4), (256, 2, 2), (384, 2, 2), (512, 1, 1), (128, 64, 1),
    (640, 1, 1), (64, 8, 8)])
def test_route_mirrors_the_kernel_gates(D, Hq, Hkv):
    """Fault F: decode_attention_supported (the route of K5 and K2) is the
    reference's rule, a head_dim multiple of 128 at any GQA ratio; K5's
    and K2's gates take every such shape up to head_dim 512 and refuse
    larger ones."""
    cfg = TL.llama_tiny(dim=Hq * D, n_heads=Hq, n_kv_heads=Hkv)
    routed = D % 128 == 0
    assert TD._use_attn_kernel(1, "int8", cfg) is routed
    assert TD._use_attn_kernel(1, False, cfg) is routed
    assert TD._scan_uses_update_kernel(1, "int8", cfg) is routed
    q = torch.zeros((2, Hq, D))
    k = torch.zeros((3, 2, 8, Hkv, D), dtype=torch.int8)
    ks = torch.zeros((3, 2, 8, Hkv))
    if D <= A.K5_MAX_HEAD_DIM:
        A.k5_check(q, k[1], k[1])
        A.k2_check(q, k, ks, 1)
    else:
        with pytest.raises(ValueError):
            A.k5_check(q, k[1], k[1])
        with pytest.raises(ValueError):
            A.k2_check(q, k, ks, 1)


def test_k2_gate_bounds_the_scores_in_shared_memory():
    """K2 holds the scores of a kv head's query heads, n_rep * (S + 1)
    f32, in shared memory: its gate takes the largest S that fits and
    refuses the next."""
    n_rep = 32
    S = A.K2_MAX_SCORES // n_rep - 1
    q = torch.zeros((1, n_rep, 128))
    for rows, ok in ((S, True), (S + 1, False)):
        k = torch.zeros((1, 1, rows, 1, 128), dtype=torch.int8)
        ks = torch.zeros((1, 1, rows, 1))
        if ok:
            A.k2_check(q, k, ks, 0)
        else:
            with pytest.raises(ValueError):
                A.k2_check(q, k, ks, 0)


def test_head_dim_384_decodes_through_k5(monkeypatch):
    """Fault F: a head_dim of 384 (a multiple of 128, past K5's old 256)
    takes the reference's route: every decode step attends through K5
    (its plain version here), and the logits match the JAX package's,
    whose decode attention kernel runs in interpret mode."""
    monkeypatch.setattr(JD, "FORCE_ATTN_KERNEL", True)
    seen = []
    real = TD.decode_attention_stacked

    def spy(q, *a):
        seen.append(q.shape[-1])
        return real(q, *a)

    monkeypatch.setattr(TD, "decode_attention_stacked", spy)
    models = _fault_models(dim=1536, n_heads=4, n_kv_heads=4)
    assert models[2].head_dim == 384
    rows, _ = _fault_decode_pair(models, True)
    _check_rows(rows)
    assert seen and set(seen) == {384}


# ---- G ----------------------------------------------------------------------

def test_prefill_cold_scanned_over_a_bf16_cache_matches_jax():
    """Fault G: the paged engine's cold admission (prefill_cold_scanned)
    over a bf16 cache writes the raw K/V rows, as the JAX package does:
    logits at each row's last real token within ATOL, and the written
    rows of every layer within 5e-2, a few bf16 ulps of rows near 1
    (activations that round differently in bf16 through the layers)."""
    cfg_j, jq, cfg_t, tq = _fault_models(fused=True)
    jp = JD.stack_layers(JD.prepare_params_host(jq))
    tp = TD.stack_layers(TD.prepare_params_host(tq))
    prompt = _fault_prompt(S=8)
    last = np.array([7, 4], np.int32)
    jc = j_init(cfg_j, 2, 16, False)
    tc = init_kv_cache(cfg_t, 2, 16, False, device="cpu")
    jl, jc = JD.prefill_cold_scanned(jp, jnp.asarray(prompt), jc, cfg_j,
                                     jnp.asarray(last))
    tl, tc = TD.prefill_cold_scanned(tp, torch.from_numpy(prompt), tc,
                                     cfg_t, torch.from_numpy(last))
    _check_rows([(np.asarray(jl, np.float32), tl.float().numpy())])
    assert tc.k_scale is None and tc.k.dtype == torch.bfloat16
    assert tc.length.tolist() == (last + 1).tolist()
    for li in range(cfg_t.n_layers):
        for jt, tt in ((jc.k, tc.k), (jc.v, tc.v)):
            j_rows = np.asarray(jt[li].astype(jnp.float32))
            t_rows = tt[li].float().numpy()
            np.testing.assert_allclose(t_rows[:, :8], j_rows[:, :8],
                                       atol=5e-2)
            assert not t_rows[:, 8:].any()


# ---- H ----------------------------------------------------------------------

def test_positional_parameters_match_the_reference():
    """Fault H: the same positional arguments mean the same thing in both
    packages: init_kv_cache(cfg, batch, max_len, quantized),
    DecodeEngine(params, cfg, max_batch, max_len, kv_quantized, eos_id,
    seed, chunk) and PagedDecodeEngine(params, cfg, max_batch, n_blocks,
    block, eos_id); ``device`` is keyword-only."""
    cfg_j, jq, cfg_t, tq = _fault_models(fused=True)
    jc = j_init(cfg_j, 2, 16, False)
    tc = init_kv_cache(cfg_t, 2, 16, False, device="cpu")
    assert tc.quantized is False and jc.quantized is False
    assert tc.k.dtype == torch.bfloat16 and jc.k[0].dtype == jnp.bfloat16
    assert tuple(tc.k.shape[1:]) == jc.k[0].shape
    with pytest.raises(TypeError):
        init_kv_cache(cfg_t, 2, 16, True, "cpu")
    with pytest.raises(TypeError):
        init_paged_kv_cache(cfg_t, 2, 4, 16, None, "cpu")

    je = JEngine(jq, cfg_j, 2, 32, False, 7, 3, 4)
    te = DecodeEngine(tq, cfg_t, 2, 32, False, 7, 3, 4, device="cpu")
    for e in (je, te):
        assert (e.max_batch, e.max_len, e.kv_quantized, e.eos_id,
                e.chunk) == (2, 32, False, 7, 4)
    assert te.cache.k.dtype == torch.bfloat16 and te.cache.k_scale is None
    assert not te._stacked_chunks  # K4 reads an int8 cache only
    jp = JPaged(jq, cfg_j, 2, 9, 16, 7)
    tp = PagedDecodeEngine(tq, cfg_t, 2, 9, 16, 7, device="cpu")
    for e in (jp, tp):
        assert (e.block, e.eos_id, e.pcache.k.shape[1]) == (16, 7, 9)
    with pytest.raises(TypeError):
        DecodeEngine(tq, cfg_t, 2, 32, True, None, 0, 8, 8, None, "cpu")
    # the int4 slot cache is the fifth positional parameter in both, and
    # K4 reads an int8 cache only, so it decodes on decode_chunk
    je4 = JEngine(jq, cfg_j, 2, 32, "int4")
    te4 = DecodeEngine(tq, cfg_t, 2, 32, "int4", device="cpu")
    assert te4.kv_quantized == je4.kv_quantized == "int4"
    assert te4.cache.k.dtype == torch.uint8 and je4.cache.k[0].dtype == jnp.uint8
    assert tuple(te4.cache.k.shape[1:]) == je4.cache.k[0].shape
    assert not te4._stacked_chunks and not je4._stacked_chunks


def test_engine_over_a_bf16_slot_cache_matches_jax(monkeypatch):
    """DecodeEngine(kv_quantized=False): admission (prefill_at) and the
    decode_chunk route over a bf16 slot cache, with a prefix-cache hit
    whose entry has no scales: the admission logits against the JAX
    engine's, and every request served in full."""
    import sparsebit_tpu.llm.serving as JS
    import sparsebit_tpu_torch.llm.serving as TS

    cfg_j, jq, cfg_t, tq = _fault_models(fused=True)
    logits = {"jax": [], "torch": []}
    for name, mod in (("jax", JS), ("torch", TS)):
        def spy(*a, _real=mod.prefill_at, _got=logits[name], **k):
            out = _real(*a, **k)
            _got.append(np.asarray(out[0], np.float32))
            return out

        monkeypatch.setattr(mod, "prefill_at", spy)
    prompts = [_fault_prompt(1, 6, seed=s)[0].tolist() for s in (1, 2)]
    prompts.append(prompts[0] + [5, 9, 11])  # a prefix hit on the first
    for eng in (JEngine(jq, cfg_j, 2, 32, False),
                DecodeEngine(tq, cfg_t, 2, 32, False, device="cpu")):
        assert getattr(eng, "kv_quantized", None) is False
        rids = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        res = eng.run()
        assert [len(res[r]) for r in rids] == [4, 4, 4]
        assert eng.prefix_hits == 1
    assert len(logits["jax"]) == len(logits["torch"]) >= 2
    _check_rows(list(zip(logits["jax"], logits["torch"])))


# ---- the full-sequence forward, perplexity and the parameter helpers --------

LOSS_RTOL = 1e-3  # mean NLL over B*S tokens: bf16 activations, f32 sums


@pytest.fixture(scope="module")
def dense_tiny():
    """llama_tiny (head_dim 64, GQA 4 -> 2) with the JAX package's random
    bf16 weights, in both packages."""
    cfg_j = JL.llama_tiny()
    jp = JL.init_llama_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, jp, TL.llama_tiny(), params_from_numpy(
        jax_tree_to_numpy(jp), "cpu")


@pytest.fixture(params=["masked", "flash"])
def route(request, monkeypatch):
    """"masked": both packages' CPU route. "flash": the port's _flash_ok
    without its device test and the JAX package's without its backend
    test (its flash kernel needs S % 128 == 0), JAX's kernel in interpret
    mode; jit caches cleared so no trace of the other route is reused."""
    if request.param == "flash":
        monkeypatch.setattr(TL, "_flash_ok",
                            lambda q: q.shape[-1] in (64, 128, 256))
        monkeypatch.setattr(JL, "_flash_ok", lambda q: (
            q.shape[1] % 128 == 0 and q.shape[-1] in (64, 128, 256)))
        jax.clear_caches()
        with pltpu.force_tpu_interpret_mode():
            yield request.param
        jax.clear_caches()
    else:
        yield request.param


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def test_llama_forward_and_loss_match_jax(dense_tiny, route):
    """B = 2, S = 128: logits within ATOL with equal decisive argmax, the
    loss within LOSS_RTOL. The JAX side runs under jax.jit: op by op, the
    main thread's next dispatch can deadlock against the io_callbacks of
    JAX's interpreted flash kernel, which dispatch ops of their own."""
    cfg_j, jp, cfg_t, tp = dense_tiny
    toks = _tokens(2, 129, 11)
    jl = np.asarray(jax.jit(JL.llama_forward, static_argnums=2)(
        jp, jnp.asarray(toks[:, :-1]), cfg_j))
    tl = TL.llama_forward(tp, torch.from_numpy(toks[:, :-1]), cfg_t)
    assert tl.dtype == torch.float32 and tl.shape == (2, 128, 512)
    _check_rows([(jl.reshape(-1, 512), tl.reshape(-1, 512).numpy())])
    j_loss = float(jax.jit(JL.llama_loss, static_argnums=2)(
        jp, jnp.asarray(toks), cfg_j))
    t_loss = float(TL.llama_loss(tp, torch.from_numpy(toks), cfg_t))
    assert abs(t_loss - j_loss) <= LOSS_RTOL * abs(j_loss)


def test_llama_backbone_returns_the_layers_kv(dense_tiny):
    """return_kv: each layer's post-rope k and raw v, (B, S, Hkv, hd)."""
    cfg_j, jp, cfg_t, tp = dense_tiny
    toks = _tokens(1, 16, 12)
    jx, jkv = JL.llama_backbone(jp, jnp.asarray(toks), cfg_j, return_kv=True)
    tx, tkv = TL.llama_backbone(tp, torch.from_numpy(toks), cfg_t,
                                return_kv=True)
    assert len(tkv) == cfg_t.n_layers
    np.testing.assert_allclose(tx.float().numpy(),
                               np.asarray(jx.astype(jnp.float32)), atol=ATOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        assert tuple(tk.shape) == jk.shape == (1, 16, 2, 64)
        np.testing.assert_allclose(tv.float().numpy(),
                                   np.asarray(jv.astype(jnp.float32)),
                                   atol=5e-2)


def test_prefill_cold_scanned_flash_route_matches_jax(route):
    """The paged engine's cold admission over an int8 cache at S = 128,
    ragged last rows: logits at the last real tokens within ATOL; layer
    0's KV codes and scales equal (same inputs, same arithmetic); a later
    layer's dequantized rows within 5e-2 (the bf16 rows' tolerance of the
    fault G test) plus one int8 step of the row (its requantization)."""
    cfg_j, jq, cfg_t, tq = _fault_models(fused=True)
    jp = JD.stack_layers(JD.prepare_params_host(jq))
    tp = TD.stack_layers(TD.prepare_params_host(tq))
    prompt = _fault_prompt(S=128, seed=7)
    last = np.array([127, 90], np.int32)
    jc = j_init(cfg_j, 2, 128, True)
    tc = init_kv_cache(cfg_t, 2, 128, True, device="cpu")
    jl, jc = JD.prefill_cold_scanned(jp, jnp.asarray(prompt), jc, cfg_j,
                                     jnp.asarray(last))
    tl, tc = TD.prefill_cold_scanned(tp, torch.from_numpy(prompt), tc,
                                     cfg_t, torch.from_numpy(last))
    _check_rows([(np.asarray(jl, np.float32), tl.float().numpy())])
    assert tc.length.tolist() == (last + 1).tolist()
    for jt, tt, js, ts in ((jc.k, tc.k, jc.k_scale, tc.k_scale),
                           (jc.v, tc.v, jc.v_scale, tc.v_scale)):
        np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
        np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))
        for li in range(1, cfg_t.n_layers):
            j_s, t_s = np.asarray(js[li]), ts[li].numpy()
            j_rows = np.asarray(jt[li]).astype(np.float32) * j_s[..., None]
            t_rows = tt[li].numpy().astype(np.float32) * t_s[..., None]
            step = np.maximum(j_s, t_s)[..., None]
            assert (np.abs(t_rows - j_rows) <= 5e-2 + step).all()


@pytest.mark.parametrize("head_chunk", [0, 48])
def test_perplexity_matches_jax(dense_tiny, route, head_chunk):
    """Three 129-token windows two at a time (a full and a one-window
    batch), the lm_head whole or in 48-token slices (a ragged last
    slice): perplexity within LOSS_RTOL of its log."""
    cfg_j, jp, cfg_t, tp = dense_tiny
    stream = _tokens(1, 3 * 129 + 5, 13)[0]
    j_ppl = JE.perplexity(jp, stream, cfg_j, seqlen=129, batch=2,
                          head_chunk=head_chunk)
    t_ppl = TE.perplexity(tp, stream, cfg_t, seqlen=129, batch=2,
                          head_chunk=head_chunk, device="cpu")
    assert abs(np.log(t_ppl) - np.log(j_ppl)) <= LOSS_RTOL * np.log(j_ppl)


def test_perplexity_needs_cuda_unless_cpu_is_asked(dense_tiny, monkeypatch):
    _, _, cfg_t, tp = dense_tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TE.perplexity(tp, np.zeros(300, np.int32), cfg_t, seqlen=129)


def test_fuse_llama_params_is_exact(dense_tiny):
    """wqkv / w13 are the columns of wq|wk|wv and w1|w3, bit for bit, as
    the JAX package fuses them; biases are carried (zeros where absent)."""
    cfg_j, jp, _, tp = dense_tiny
    jf = params_from_numpy(jax_tree_to_numpy(JL.fuse_llama_params(jp)),
                           "cpu")
    tf = TL.fuse_llama_params(tp)
    assert set(tf) == set(jf)
    for jl_, tl_ in zip(jf["layers"], tf["layers"]):
        assert set(tl_) == set(jl_) == {"attn_norm", "ffn_norm", "wqkv",
                                        "wo", "w13", "w2"}
        for name in ("wqkv", "w13"):
            assert torch.equal(tl_[name].w, jl_[name].w)
            assert tl_[name].bias is None
    layer = dict(tp["layers"][0])
    bias = torch.arange(layer["wk"].w.shape[1], dtype=torch.bfloat16)
    layer["wk"] = TL.DenseLinear(layer["wk"].w, bias)
    fused = TL.fuse_llama_params(dict(tp, layers=[layer]))["layers"][0]
    nq, nk = layer["wq"].w.shape[1], layer["wk"].w.shape[1]
    b = fused["wqkv"].bias
    assert torch.equal(b[nq:nq + nk], bias)
    assert not b[:nq].any() and not b[nq + nk:].any()


def test_llama_13b_and_init_params_match_jax(monkeypatch):
    """llama_13b field for field; init_llama_params with the JAX package's
    keys, shapes and dtypes (f32 and bf16 configs), the same draws for one
    generator seed, others for another, and the card by default."""
    j13, t13 = JL.llama_13b(), TL.llama_13b()
    assert dataclasses.asdict(t13) == dataclasses.asdict(j13)
    for dtype in ("bfloat16", "float32"):
        cfg_j = JL.llama_tiny(dtype=dtype, n_layers=2)
        cfg_t = TL.llama_tiny(dtype=dtype, n_layers=2)
        jp = params_from_numpy(jax_tree_to_numpy(JL.init_llama_params(
            cfg_j, jax.random.PRNGKey(1))), "cpu")
        tp = TL.init_llama_params(cfg_t, torch.Generator().manual_seed(4),
                                  device="cpu")
        assert set(tp) == set(jp)
        for tl_, jl_ in zip(tp["layers"], jp["layers"]):
            assert set(tl_) == set(jl_)
        leaves = [("tok_embed", tp["tok_embed"], jp["tok_embed"]),
                  ("norm", tp["norm"], jp["norm"]),
                  ("lm_head", tp["lm_head"].w, jp["lm_head"].w)]
        for li, (tl_, jl_) in enumerate(zip(tp["layers"], jp["layers"])):
            for name in tl_:
                tv, jv = tl_[name], jl_[name]
                if not isinstance(tv, torch.Tensor):
                    tv, jv = tv.w, jv.w
                leaves.append(("{}.{}".format(li, name), tv, jv))
        for name, tv, jv in leaves:
            assert tv.shape == jv.shape and tv.dtype == jv.dtype, name
            assert tv.dtype == cfg_t.torch_dtype, name
        assert torch.equal(tp["norm"], torch.ones(cfg_t.dim,
                                                  dtype=cfg_t.torch_dtype))
        w = tp["layers"][0]["wq"].w.float()
        assert 0.015 < w.std().item() < 0.025  # N(0, 0.02)
    again = TL.init_llama_params(cfg_t, torch.Generator().manual_seed(4),
                                 device="cpu")
    other = TL.init_llama_params(cfg_t, torch.Generator().manual_seed(5),
                                 device="cpu")
    assert torch.equal(again["layers"][1]["w2"].w, tp["layers"][1]["w2"].w)
    assert torch.equal(again["tok_embed"], tp["tok_embed"])
    assert not torch.equal(other["tok_embed"], tp["tok_embed"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TL.init_llama_params(cfg_t)


# ---- QLoRA (llm/qlora.py) -----------------------------------------------------
#
# llama_tiny (head_dim 64, GQA 4 -> 2) quantized by the JAX package (RTN
# INT4 g32, as tests/test_llm.py), wrapped with r = 4 adapters on wq/wv and
# carried across by params_from_numpy; the adapters' A and B come from
# numpy (B nonzero, so that gradients reach A too) into both packages.
# Tolerance on the adapters' gradients: relative norm 0.05 and cosine
# 0.999 against jax.grad: bf16 activations round differently where f32
# sums run in another order (the port's plain K8 groups against the
# reference's dense product on the CPU), and the int8 backward requantizes
# each g row, so a code moves by one where two roundings disagree; the
# loss within LOSS_RTOL.

GRAD_REL, GRAD_COS = 0.05, 0.999


@pytest.fixture(scope="module")
def qlora_tiny():
    from sparsebit_tpu.llm import qlora as JQ

    cfg_j = JL.llama_tiny()
    jp = JL.init_llama_params(cfg_j, jax.random.PRNGKey(0))
    rtn = jax.jit(lambda w: JQuant.from_dense(w.astype(jnp.float32),
                                              bits=4, groupsize=32))
    qp = JL.quantize_llama_params(jp, lambda p, lin: rtn(lin.w))
    lp = JQ.wrap_llama_lora(qp, r=4, targets=("wq", "wv"))
    rng = np.random.default_rng(7)
    lora = {key: {n: (rng.standard_normal(a.shape) * 0.05).astype(
        np.float32) for n, a in leaves.items()}
        for key, leaves in JQ.extract_lora(lp).items()}
    return cfg_j, lp, TL.llama_tiny(), lora


def _loras(lora):
    """The numpy adapters as (JAX tree, port tree of fresh tensors)."""
    j = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in
         lora.items()}
    t = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()} for k, v
         in lora.items()}
    return j, t


def _flat(tree, get=lambda t: t):
    return np.concatenate([np.asarray(get(tree[k][n]), np.float32).ravel()
                           for k in sorted(tree) for n in ("lora_A",
                                                           "lora_B")])


def _grads_agree(a, b, rel=GRAD_REL, cos=GRAD_COS):
    r = np.linalg.norm(a - b) / np.linalg.norm(b)
    c = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert r < rel and c > cos, (r, c)


def _tensors(tree):
    """Every tensor of a params tree (linears' fields included)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "__dict__"):
        return _tensors(tree.__dict__)
    return []


@pytest.mark.parametrize("route,prepared", [
    ("masked", False), ("masked", True), ("flash", False)],
    indirect=["route"])
def test_qlora_loss_and_grads_match_jax(qlora_tiny, route, prepared):
    """qlora_loss_fn and the adapters' gradients against
    jax.value_and_grad(qlora_loss_fn), the dense backward and, after
    prepare_train, the int8 one, on the masked route and on the flash
    route (the port's flash autograd.Function on the plain versions of
    K10/K11/K12, JAX's flash kernels in interpret mode): B = 2, S = 32
    masked, 128 flash (the TPU kernel's block)."""
    from sparsebit_tpu.llm import qlora as JQ
    from sparsebit_tpu_torch.llm import qlora as TQ

    cfg_j, lp, cfg_t, lora = qlora_tiny
    if prepared:
        lp = jax.jit(JQ.prepare_train)(lp)
    tp = params_from_numpy(jax_tree_to_numpy(lp), "cpu")
    toks = _tokens(2, 129 if route == "flash" else 33, 14)
    jl, tl = _loras(lora)
    j_loss, j_grads = jax.jit(jax.value_and_grad(JQ.qlora_loss_fn),
                              static_argnums=3)(jl, lp, jnp.asarray(toks),
                                                cfg_j)
    TQ.lora_parameters(tl)
    t_loss = TQ.qlora_loss_fn(tl, tp, torch.from_numpy(toks), cfg_t)
    t_loss.backward()
    assert abs(t_loss.item() - float(j_loss)) <= LOSS_RTOL * float(j_loss)
    _grads_agree(_flat(tl, lambda t: t.grad), _flat(j_grads))


def test_qlora_adamw_steps_match_optax(qlora_tiny):
    """Two qlora_train_steps with adamw (torch's AdamW at optax.adamw's
    weight decay 1e-4) against two JAX qlora_train_steps with
    optax.adamw: the losses within LOSS_RTOL; the optimiser itself against
    optax.adamw fed the port's own gradients, leaves within 1e-7 + 1e-6
    relative (f32 updates in another order). Only the adapters change:
    every backbone tensor is bit-equal after the steps."""
    import optax

    from sparsebit_tpu.llm import qlora as JQ
    from sparsebit_tpu_torch.llm import qlora as TQ

    cfg_j, lp, cfg_t, lora = qlora_tiny
    tp = params_from_numpy(jax_tree_to_numpy(lp), "cpu")
    backbone = [t.clone() for t in _tensors(tp)]
    toks = _tokens(2, 33, 15)
    lr = 1e-3
    jl, tl = _loras(lora)
    j_opt = optax.adamw(lr)
    j_step = jax.jit(JQ.qlora_train_step, static_argnums=(4, 5))
    state = j_opt.init(jl)
    opt = TQ.adamw(tl, lr)
    assert opt.defaults["weight_decay"] == 1e-4
    t_grads = []
    for _ in range(2):
        jl, state, j_loss = j_step(jl, state, lp, jnp.asarray(toks), cfg_j,
                                   j_opt)
        tl, t_loss = TQ.qlora_train_step(tl, opt, tp, torch.from_numpy(toks),
                                         cfg_t)
        assert abs(t_loss.item() - float(j_loss)) <= LOSS_RTOL * float(
            j_loss)
        t_grads.append({k: {n: jnp.asarray(t.grad.numpy()) for n, t in
                            v.items()} for k, v in tl.items()})
    ref, _ = _loras(lora)
    state = j_opt.init(ref)
    for g in t_grads:
        updates, state = j_opt.update(g, state, ref)
        ref = optax.apply_updates(ref, updates)
    got, want = _flat(tl, lambda t: t.detach()), _flat(ref)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got != _flat(lora)).all()
    for a, b in zip(backbone, _tensors(tp)):
        assert torch.equal(a, b)


def test_qlora_wrap_merge_and_prepare_train(qlora_tiny):
    """wrap_llama_lora starts as the base (B = 0, A ~ N(0, 1/K)); after
    training-like adapters merge_llama_lora's dense weights give the
    injected forward's logits (within 2e-2, the reference's own test);
    prepare_train gives every QuantLinear, LoRA bases included, an int8
    W^T, and params_from_numpy carries them across equal to the JAX
    package's."""
    from sparsebit_tpu.llm import qlora as JQ
    from sparsebit_tpu_torch.llm import qlora as TQ

    cfg_j, lp, cfg_t, lora = qlora_tiny
    qp = params_from_numpy(jax_tree_to_numpy(lp), "cpu")
    base = {**qp, "layers": [{k: (v.base if isinstance(v, TQ.LoraLinear)
                                  else v) for k, v in layer.items()}
                             for layer in qp["layers"]]}
    wrapped = TQ.wrap_llama_lora(base, r=4, targets=("wq", "wv"),
                                 generator=torch.Generator().manual_seed(3))
    toks = torch.from_numpy(_tokens(2, 16, 16))
    a = wrapped["layers"][1]["wv"].lora_A
    assert tuple(a.shape) == (cfg_t.dim, 4) and not wrapped["layers"][1][
        "wv"].lora_B.any()
    assert 0.5 < a.std().item() * cfg_t.dim ** 0.5 < 1.5
    assert torch.equal(TL.llama_forward(wrapped, toks, cfg_t),
                       TL.llama_forward(base, toks, cfg_t))
    _, tl = _loras(lora)
    injected = TQ.inject_lora(wrapped, tl)
    merged = TQ.merge_llama_lora(injected)
    assert isinstance(merged["layers"][0]["wq"], TL.DenseLinear)
    np.testing.assert_allclose(
        TL.llama_forward(merged, toks, cfg_t).numpy(),
        TL.llama_forward(injected, toks, cfg_t).numpy(), rtol=2e-2,
        atol=2e-2)
    jt = jax.jit(JQ.prepare_train)(lp)  # as the reference runs it
    tt = params_from_numpy(jax_tree_to_numpy(jt), "cpu")
    mine = TQ.prepare_train(qp)
    for lj, lt in zip(tt["layers"], mine["layers"]):
        for name in ("wq", "wo"):
            j_lin, t_lin = lj[name], lt[name]
            if name == "wq":
                j_lin, t_lin = j_lin.base, t_lin.base
            assert t_lin.bwd_wq.dtype == torch.int8
            assert torch.equal(t_lin.bwd_wq, j_lin.bwd_wq)
            assert torch.equal(t_lin.bwd_scale, j_lin.bwd_scale)


def test_qlora_int8_grads_stay_near_f32(qlora_tiny):
    """The reference's own bound (tests/test_llm.py:240-279) on the port:
    the adapters' gradients through the int8 backward (prepare_train)
    within relative norm 0.15 and cosine 0.99 of the dense backward's,
    and a train step through it runs and moves the adapters."""
    from sparsebit_tpu_torch.llm import qlora as TQ

    _, lp, cfg_t, lora = qlora_tiny
    qp = params_from_numpy(jax_tree_to_numpy(lp), "cpu")
    toks = torch.from_numpy(_tokens(2, 17, 17))
    flat = []
    for params in (qp, TQ.prepare_train(qp)):
        _, tl = _loras(lora)
        TQ.lora_parameters(tl)
        TQ.qlora_loss_fn(tl, params, toks, cfg_t).backward()
        flat.append(_flat(tl, lambda t: t.grad))
    _grads_agree(flat[1], flat[0], rel=0.15, cos=0.99)
    _, tl = _loras(lora)
    _, loss = TQ.qlora_train_step(tl, TQ.adamw(tl, 1e-2), params, toks,
                                  cfg_t)
    assert torch.isfinite(loss)
    assert (_flat(tl, lambda t: t.detach()) != _flat(lora)).any()
