"""The port's scanned KVCache API (prefill_scanned, decode_step_scanned,
decode_tokens_scanned) against the JAX package, on the CPU, and the two
repairs that came with it: the cache entry points run on the card unless
the CPU is named, and the scanned routing looks at the cache mode.

The model is the reference tests' tiny one (dim 512, 4 heads of 128, ffn
384, two fused layers, g64 RTN), quantized by the JAX package and carried
across as arrays; both sides prepare it with prepare_params_host and
stack_layers. JAX runs with ``FORCE_LAYER_KERNEL = True`` (its
megakernel, planes or nibbles, in interpret mode) and
``FORCE_FFN_KERNEL = True``; the port with its default routing, K4's
plain version included.

Tolerance: logits within ATOL 0.1, argmax equal where the top-2 margin
exceeds 2 * ATOL (tests/test_layer_fused.py:469-498): bf16 activations
round differently when f32 sums are taken in another order.
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
from sparsebit_tpu.llm.serving import DecodeEngine as JEngine
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.kv_cache import (
    init_kv_cache,
    init_paged_kv_cache,
)
from sparsebit_tpu_torch.llm.quant import QuantLinear
from sparsebit_tpu_torch.llm.serving import DecodeEngine, PagedDecodeEngine

from test_torch_engine import jax_tree_to_numpy

torch.set_num_threads(1)

ATOL = 0.1
CFG = dict(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=384, max_seq_len=64,
           n_layers=2)


def _models(bits):
    cfg_j = JL.llama_tiny(**CFG)
    params = JL.fuse_llama_params(
        JL.init_llama_params(cfg_j, jax.random.PRNGKey(5)))
    jq = JL.quantize_llama_params(params, lambda p, lin: JQuant.from_dense(
        lin.w.astype(jnp.float32), bits=bits, groupsize=64))
    return cfg_j, jq, TL.llama_tiny(**CFG), params_from_numpy(
        jax_tree_to_numpy(jq), "cpu")


@pytest.fixture(scope="module")
def int3():
    return _models(3)


@pytest.fixture(scope="module")
def int4():
    return _models(4)


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setattr(JD, "FORCE_LAYER_KERNEL", True)
    monkeypatch.setattr(JD, "FORCE_FFN_KERNEL", True)
    monkeypatch.setattr(TD, "FORCE_FFN_KERNEL", True)


def _prompt(B=2, S=5, seed=6):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _check_rows(rows):
    for lj, lt in rows:
        np.testing.assert_allclose(lt, lj, atol=ATOL)
        top2 = np.sort(lj, -1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 2 * ATOL
        np.testing.assert_array_equal(lt.argmax(-1)[decisive],
                                      lj.argmax(-1)[decisive])


def _scanned_pair(models, sub4, kv_quantized, n=4):
    """prefill_scanned then n teacher-forced decode_step_scanned on both
    sides (the JAX greedy tokens fed to both); returns the rows of
    logits, the JAX tokens and the port's stacked params."""
    cfg_j, jq, cfg_t, tq = models
    jp = JD.stack_layers(JD.prepare_params_host(jq, sub4=sub4))
    tp = TD.stack_layers(TD.prepare_params_host(tq, sub4=sub4))
    prompt = _prompt()
    jc = j_init(cfg_j, 2, 32, kv_quantized)
    tc = init_kv_cache(cfg_t, 2, 32, device="cpu", quantized=kv_quantized)
    jl, jc = JD.prefill_scanned(jp, jnp.asarray(prompt), jc, cfg_j)
    tl, tc = TD.prefill_scanned(tp, torch.from_numpy(prompt), tc, cfg_t)
    rows, toks = [(np.asarray(jl, np.float32), tl.numpy())], []
    for _ in range(n):
        tok = rows[-1][0].argmax(-1).astype(np.int32)
        toks.append(tok)
        jl, jc = JD.decode_step_scanned(jp, jnp.asarray(tok), jc, cfg_j)
        tl, tc = TD.decode_step_scanned(tp, torch.from_numpy(tok), tc,
                                        cfg_t)
        rows.append((np.asarray(jl, np.float32), tl.numpy()))
    assert tc.length.tolist() == [5 + n] * 2
    return rows, toks, tp


@pytest.mark.parametrize("sub4", ["planes", "nibble"])
@pytest.mark.parametrize("kv_quantized", [True, False])
def test_scanned_api_matches_jax(int3, jax_kernels, sub4, kv_quantized):
    """An int3 model served as planes (K4's plane mode over an int8 cache)
    or as s4 nibbles (K4's nibble mode), over an int8 or a bf16 cache (the
    plain per-layer branch): prefill_scanned and decode_step_scanned
    logits against JAX's. decode_tokens_scanned emits the port's own
    greedy decode_step_scanned tokens exactly, and JAX's greedy tokens up
    to each row's first step whose top-2 margin is within twice the logit
    error."""
    rows, toks, tp = _scanned_pair(int3, sub4, kv_quantized)
    _check_rows(rows)
    if sub4 == "planes":
        assert "pl" in tp["layers"]["wqkv"].packed
    cfg_t = int3[2]
    n = len(toks) - 1
    greedy, caches = [], []
    for _ in range(2):
        tc = init_kv_cache(cfg_t, 2, 32, device="cpu",
                           quantized=kv_quantized)
        lt, tc = TD.prefill_scanned(tp, torch.from_numpy(_prompt()), tc,
                                    cfg_t)
        caches.append(tc)
    tok = lt.argmax(-1).to(torch.int32)
    got, tc = TD.decode_tokens_scanned(tp, tok, caches[0], cfg_t, n)
    for _ in range(n):
        lg, _ = TD.decode_step_scanned(tp, tok, caches[1], cfg_t)
        tok = lg.argmax(-1).to(torch.int32)
        greedy.append(tok)
    assert torch.equal(got, torch.stack(greedy, 1))
    assert tc.length.tolist() == caches[1].length.tolist() == [5 + n] * 2
    assert torch.equal(tc.k, caches[1].k)
    err = max(np.abs(lj - lt).max() for lj, lt in rows)
    ref = np.stack(toks[1:], 1)
    checked = 0
    for b in range(2):
        for t in range(ref.shape[1]):
            lj = rows[t + 1][0][b]
            top2 = np.sort(lj)[-2:]
            if top2[1] - top2[0] <= 2 * err:
                break
            assert got[b, t] == ref[b, t], (b, t)
            checked += 1
    assert checked >= 1


def test_bf16_cache_takes_no_k4(int4, jax_kernels, monkeypatch):
    """Fault D: an s4r model K4 takes over an int8 cache, stepped over a
    bf16 cache, runs the plain per-layer attention (no K4, no K2) and
    matches JAX's decode_step_scanned; so does a prompt (S > 1) over an
    int8 cache."""
    calls = []

    def trap(name):
        def fn(*a, **k):
            calls.append(name)
            raise AssertionError(name)
        return fn

    monkeypatch.setattr(TD, "fused_decoder_layers", trap("K4"))
    monkeypatch.setattr(TD, "decode_attention_update", trap("K2"))
    rows, _, tp = _scanned_pair(int4, "nibble", False, n=3)
    _check_rows(rows)
    assert TD._layer_kernel_ok(tp["layers"], int4[2], 2)
    cfg_j, jq, cfg_t, _ = int4
    jp = JD.stack_layers(JD.prepare_params_host(jq))
    jl, _ = JD.prefill_scanned(jp, jnp.asarray(_prompt()),
                               j_init(cfg_j, 2, 32, True), cfg_j)
    tl, _ = TD.prefill_scanned(
        tp, torch.from_numpy(_prompt()),
        init_kv_cache(cfg_t, 2, 32, device="cpu"), cfg_t)
    _check_rows([(np.asarray(jl, np.float32), tl.numpy())])
    assert calls == []


def test_uniform_int3_planes_match_nibble(int3):
    """The same int3 checkpoint served as planes and as nibbles through the
    port's scanned API (tests/test_layer_fused.py:659-710): the stack is
    3N/8 bytes wide, prefill logits within 0.05, four greedy steps
    emit equal tokens."""
    _, _, cfg_t, tq = int3
    outs = {}
    for sub4 in ("nibble", "planes"):
        sp = TD.stack_layers(TD.prepare_params_host(tq, sub4=sub4))
        assert TD._scan_uses_layer_kernel(1, sp["layers"], "int8", cfg_t, 2)
        if sub4 == "planes":
            w = sp["layers"]["wqkv"]
            assert w.bits == 3 and w.packed["pl"].shape[-1] * 8 == (
                3 * w.n_padded)
        cache = init_kv_cache(cfg_t, 2, 32, device="cpu")
        logits, cache = TD.prefill_scanned(sp, torch.from_numpy(_prompt()),
                                           cache, cfg_t)
        toks = [logits.argmax(-1).to(torch.int32)]
        for _ in range(4):
            lg, cache = TD.decode_step_scanned(sp, toks[-1], cache, cfg_t)
            toks.append(lg.argmax(-1).to(torch.int32))
        outs[sub4] = (logits, toks)
    np.testing.assert_allclose(outs["planes"][0].numpy(),
                               outs["nibble"][0].numpy(), atol=0.05)
    for a, b in zip(outs["planes"][1], outs["nibble"][1]):
        assert torch.equal(a, b)


def test_prepare_stacked_params_leaves_planes_alone(int3):
    """prepare_stacked_params_for_decode adds no s4r copy to a "pl" stack
    (K4 reads the planes); a fold-layout stack gains it (K1)."""
    tq = int3[3]
    planes = TD.stack_layers(TD.prepare_params_host(tq, sub4="planes"))
    out = TD.prepare_stacked_params_for_decode(planes)
    for n in ("wqkv", "wo", "w13", "w2"):
        assert out["layers"][n] is planes["layers"][n]
    fold = TD.prepare_stacked_params_for_decode(TD.stack_layers(tq))
    assert "s4r" in fold["layers"]["w13"].packed


def test_cache_entry_points_need_cuda_unless_cpu_is_asked(int4,
                                                          monkeypatch):
    """Fault C: init_kv_cache and init_paged_kv_cache run on the card by
    default and raise without CUDA unless device="cpu" is named."""
    cfg_t = int4[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        init_kv_cache(cfg_t, 2, 16)
    with pytest.raises(RuntimeError):
        init_paged_kv_cache(cfg_t, 2, 4)
    with pytest.raises(RuntimeError):
        init_kv_cache(cfg_t, 2, 16, device="cuda")
    assert init_kv_cache(cfg_t, 2, 16, device="cpu").k.device.type == "cpu"
    pool = init_paged_kv_cache(cfg_t, 2, 4, device="cpu")
    assert pool.k.device.type == "cpu" and pool.block_table.shape == (2, 1)


def test_engine_head_bits_matches_jax(int4):
    """DecodeEngine(head_bits=8): the dense head RTN-quantized per channel
    (serving.py:281-289) into the JAX engine's container bit for bit, its
    logits within ATOL of JAX's; the paged engine takes it too, and a
    request is served through it."""
    cfg_j, jq, cfg_t, tq = int4
    je = JEngine(jq, cfg_j, max_batch=2, max_len=32, head_bits=8)
    te = DecodeEngine(tq, cfg_t, max_batch=2, max_len=32, head_bits=8,
                      device="cpu")
    jh, th = je.params["lm_head"], te.params["lm_head"]
    assert isinstance(th, QuantLinear) and th.bits == 8
    np.testing.assert_array_equal(th.packed["w"].numpy(),
                                  np.asarray(jh.packed["w"]))
    np.testing.assert_array_equal(
        th.scales.float().numpy(), np.asarray(jh.scales.astype(jnp.float32)))
    x = np.random.default_rng(2).standard_normal((3, 512)).astype(np.float32)
    np.testing.assert_allclose(
        th(torch.from_numpy(x)).numpy(),
        np.asarray(jh(jnp.asarray(x)), np.float32), atol=ATOL)
    pe = PagedDecodeEngine(tq, cfg_t, max_batch=2, max_len=32, head_bits=8,
                           device="cpu")
    assert pe.params["lm_head"].bits == 8
    rid = te.add_request(_prompt(1, 6)[0].tolist(), max_new_tokens=3)
    out = te.run()
    assert len(out[rid]) == 3


@pytest.fixture
def fresh_jit():
    """JAX's scanned entry points read the FORCE_* switches when they are
    traced: clear the compiled programs around a test that flips them."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _unfused_rows(tp, cfg_t, prompt, feed):
    """The port's prefill_scanned and teacher-forced decode_step_scanned
    logits over a fresh int8 cache."""
    tc = init_kv_cache(cfg_t, 2, 32, device="cpu")
    tl, tc = TD.prefill_scanned(tp, torch.from_numpy(prompt), tc, cfg_t)
    rows = [tl.numpy()]
    for tok in feed:
        tl, tc = TD.decode_step_scanned(tp, torch.from_numpy(tok), tc, cfg_t)
        rows.append(tl.numpy())
    return rows


@pytest.mark.parametrize("force", [None, True, False])
def test_force_ffn_kernel_switch_matches_jax(int4, fresh_jit, monkeypatch,
                                             force):
    """decode.FORCE_FFN_KERNEL (the reference's decode.py:300) on the
    unfused scan (FORCE_LAYER_KERNEL = False, K2 for the attention): None
    and True run each FFN block as K3 (its plain version here), False on
    the stacked linears. Each setting's prefill and teacher-forced decode
    logits agree with the default's (None) within ATOL with equal
    decisive argmax, and match JAX's jitted prefill_scanned /
    decode_step_scanned under the same switch (its attention-update
    kernel forced on; its None is the plain block off the TPU)."""
    cfg_j, jq, cfg_t, tq = int4
    jp = JD.stack_layers(JD.prepare_params_host(jq))
    tp = TD.stack_layers(TD.prepare_params_host(tq))
    monkeypatch.setattr(TD, "FORCE_LAYER_KERNEL", False)
    monkeypatch.setattr(JD, "FORCE_LAYER_KERNEL", False)
    monkeypatch.setattr(JD, "FORCE_ATTN_KERNEL", True)
    monkeypatch.setattr(JD, "FORCE_FFN_KERNEL", force)
    k3 = TD.ffn_block_fused
    calls = []
    monkeypatch.setattr(TD, "ffn_block_fused",
                        lambda *a, **k: calls.append(1) or k3(*a, **k))
    prompt = _prompt()
    feed = [np.array([7, 300], np.int32), np.array([41, 2], np.int32),
            np.array([511, 88], np.int32)]
    default = _unfused_rows(tp, cfg_t, prompt, feed)
    del calls[:]
    monkeypatch.setattr(TD, "FORCE_FFN_KERNEL", force)
    assert TD._scan_uses_ffn_kernel(1, tp["layers"], cfg_t, 2) is (
        force is not False)
    got = _unfused_rows(tp, cfg_t, prompt, feed)
    assert len(calls) == (0 if force is False
                          else len(feed) * cfg_t.n_layers)
    jc = j_init(cfg_j, 2, 32, True)
    jl, jc = JD.prefill_scanned(jp, jnp.asarray(prompt), jc, cfg_j)
    want = [np.asarray(jl, np.float32)]
    for tok in feed:
        jl, jc = JD.decode_step_scanned(jp, jnp.asarray(tok), jc, cfg_j)
        want.append(np.asarray(jl, np.float32))
    _check_rows(list(zip(want, got)))
    _check_rows(list(zip(default, got)))
