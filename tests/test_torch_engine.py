"""The port's LLaMA serving slice against the JAX package, on the CPU.

Weights are made once by the JAX package (tiny LLaMA, fused wqkv/w13,
4-bit g64 RTN), carried across with llm.convert.params_from_numpy, and
served by both sides. The engine and decode tests run on both decode
routes (the ``route`` parameter):

- "megakernel": the route both engines take by default for this model.
  The reference is the unmodified JAX DecodeEngine with
  ``FORCE_LAYER_KERNEL = True`` (its megakernel in interpret mode; on a
  TPU the switch is not needed), against the port with default routing
  (K4's plain version).
- "unfused": the unfused branch of the scanned decode (K1, K2, K3 per
  layer), which neither engine takes by itself (decode.py:464-548): the
  port's ``_ScannedTEngine`` with ``FORCE_LAYER_KERNEL = False`` against
  ``_ScannedJEngine``, both sending their decode chunks through
  decode_chunk_scanned on stack_layers params, the JAX attention-update
  and FFN kernels forced on.
- "chunk": the route both engines take for a model the megakernel
  refuses (serving.py:308-321), decode_chunk over per-layer params: the
  port with ``FORCE_LAYER_KERNEL = False`` (K1 and K5's plain versions)
  against the unmodified JAX DecodeEngine (which takes that route on the
  CPU) with ``FORCE_ATTN_KERNEL = True`` (its K5 in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import decode as JD
from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.qlora import LoraLinear as JLora
from sparsebit_tpu.llm.quant import DenseLinear as JDense
from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu.llm.serving import DecodeEngine as JEngine
from sparsebit_tpu.llm.serving import _serving_layout as j_serving_layout
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
from sparsebit_tpu_torch.llm.quant import QuantLinear
from sparsebit_tpu_torch.llm.serving import DecodeEngine
from sparsebit_tpu_torch.llm.serving import _serving_layout

torch.set_num_threads(1)

ATOL = 0.1  # logits, as tests/test_ffn_fused.py: bf16 activations
MAX_LEN = 128


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def jax_tree_to_numpy(tree):
    """JAX params -> the numpy tree params_from_numpy reads (bf16 as a
    uint16 view)."""
    if isinstance(tree, JQuant):
        out = {"packed": {k: _np(v) for k, v in tree.packed.items()},
               "scales": _np(tree.scales), "zeros": _np(tree.zeros),
               "bits": tree.bits, "groupsize": tree.groupsize,
               "out_features": tree.out_features,
               "bias": None if tree.bias is None else _np(tree.bias),
               "perm": None if tree.perm is None else _np(tree.perm),
               "impl": tree.impl}
        if tree.bwd_wq is not None:  # after prepare_backward
            out.update(bwd_wq=_np(tree.bwd_wq), bwd_scale=_np(tree.bwd_scale))
        return out
    if isinstance(tree, JLora):
        return {"base": jax_tree_to_numpy(tree.base),
                "lora_A": _np(tree.lora_A), "lora_B": _np(tree.lora_B),
                "alpha": tree.alpha, "dropout": tree.dropout}
    if isinstance(tree, JDense):
        return {"w": _np(tree.w),
                "bias": None if tree.bias is None else _np(tree.bias)}
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return _np(tree)


@pytest.fixture(scope="module")
def model():
    cfg_j = JL.llama_tiny(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=512)
    params = JL.fuse_llama_params(
        JL.init_llama_params(cfg_j, jax.random.PRNGKey(0)))
    qparams = JL.quantize_llama_params(
        params, lambda p, lin: JQuant.from_dense(
            lin.w.astype(jnp.float32), bits=4, groupsize=64))
    cfg_t = TL.llama_tiny(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=512)
    tparams = params_from_numpy(jax_tree_to_numpy(qparams), "cpu")
    return cfg_j, qparams, cfg_t, tparams


SCANNED_ROUTES = ["megakernel", "unfused"]
ROUTES = SCANNED_ROUTES + ["chunk"]


@pytest.fixture
def forced_kernels(monkeypatch, route):
    """Both sides on ``route`` (see the module docstring)."""
    if route == "megakernel":
        monkeypatch.setattr(JD, "FORCE_LAYER_KERNEL", True)
        return
    monkeypatch.setattr(JD, "FORCE_ATTN_KERNEL", True)
    monkeypatch.setattr(TD, "FORCE_LAYER_KERNEL", False)
    if route == "unfused":
        monkeypatch.setattr(JD, "FORCE_FFN_KERNEL", True)


def test_params_from_numpy_roundtrip(model):
    """Packed codes, qparams, bf16 leaves and metadata carry over exactly,
    and the port's QuantLinear dequantizes to the JAX values."""
    _, qparams, _, tparams = model
    jl, tl = qparams["layers"][1]["w13"], tparams["layers"][1]["w13"]
    assert isinstance(tl, QuantLinear)
    assert (tl.bits, tl.groupsize, tl.out_features) == (
        jl.bits, jl.groupsize, jl.out_features)
    np.testing.assert_array_equal(tl.packed["w"].numpy(),
                                  np.asarray(jl.packed["w"]))
    np.testing.assert_array_equal(tl.dequantize().numpy(),
                                  np.asarray(jl.dequantize()))
    emb = tparams["tok_embed"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.view(torch.int16).numpy().view(np.uint16),
        np.asarray(qparams["tok_embed"]).view(np.uint16))
    assert tparams["lm_head"].w.dtype == torch.bfloat16


@pytest.mark.parametrize("layout", ["fold", "serving", "stacked"])
def test_quant_linear_a8_matches_jax(model, layout):
    """W4A8 linear on the checkpoint's fold container (the dequant oracle
    path), on the serving layout (s4r, bf16 qparams: K1's plain version)
    and layer-stacked, against the JAX one: rtol/atol 2e-4 in f32."""
    _, qparams, _, tparams = model
    name, li = "wqkv", 1
    x = np.random.default_rng(0).standard_normal((3, 512)).astype(
        np.float32)
    if layout == "fold":
        j = qparams["layers"][li][name]
        j = JQuant(j.packed, j.scales, j.zeros, j.bits, j.groupsize,
                   j.out_features, impl="a8")
        ref = j(jnp.asarray(x))
        out = tparams["layers"][li][name]._replace(impl="a8")(
            torch.from_numpy(x))
    elif layout == "stacked":
        j = JD.stack_layers({"layers": qparams["layers"]})["layers"][name]
        j = j_serving_layout(j)
        ref = j.call_stacked(jnp.asarray(x), jnp.int32(li))
        t = _serving_layout(
            TD.stack_layers({"layers": tparams["layers"]})["layers"][name])
        out = t.call_stacked(torch.from_numpy(x), li)
    else:
        ref = j_serving_layout(qparams["layers"][li][name])(jnp.asarray(x))
        t = _serving_layout(tparams["layers"][li][name])
        assert "s4r" in t.packed and t.scales.dtype == torch.bfloat16
        out = t(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


class _ScannedJEngine(JEngine):
    """The JAX engine with every decode chunk on the unfused scanned path
    (decode_chunk_scanned over stack_layers params), which the JAX engine
    itself takes for no model."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._stacked = JD.stack_layers(self.params)

    def _decode_chunk_call(self, temps, key, n):
        return JD.decode_chunk_scanned(self._stacked, self.next_tok,
                                       self.cache, temps, key, self.cfg, n)


class _ScannedTEngine(DecodeEngine):
    """The port's engine with every decode chunk on the scanned path, as
    _ScannedJEngine (with FORCE_LAYER_KERNEL = False: the unfused
    branch)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._stacked = TD.stack_layers(self.params)

    def _decode_chunk_call(self, temps, n):
        return TD.decode_chunk_scanned(self._stacked, self.next_tok,
                                       self.cache, temps, self._gen,
                                       self.cfg, n)


def _requests():
    rng = np.random.default_rng(5)
    first = rng.integers(0, 512, 12)
    return [first, rng.integers(0, 512, 5), rng.integers(0, 512, 27),
            np.concatenate([first, rng.integers(0, 512, 6)])]  # prefix hit


def _record_decisions(teng, monkeypatch):
    """rid -> the port engine's logits row behind each token it decided
    (admission and decode chunks), in order."""
    from sparsebit_tpu_torch.llm import serving as TS

    rows, order = {}, []  # order: rids of the next sampled rows
    orig_sample = TD.sample_logits_vec

    def sample(logits, temps, generator=None):
        for rid, row in zip(order, logits):
            if rid is not None:
                rows.setdefault(rid, []).append(row.clone())
        return orig_sample(logits, temps, generator)

    orig_admit, orig_chunk = teng._admit_group, teng._decode_chunk

    def admit(admits, *a):
        order[:] = [req.rid for _, req, _ in admits]
        return orig_admit(admits, *a)

    def chunk(temps, n):
        order[:] = [s.rid if s is not None else None for s in teng.slots]
        return orig_chunk(temps, n)

    for mod in (TD, TS):
        monkeypatch.setattr(mod, "sample_logits_vec", sample)
    monkeypatch.setattr(teng, "_admit_group", admit)
    monkeypatch.setattr(teng, "_decode_chunk", chunk)
    return rows


NEAR_TIE = 0.1  # twice the chunk route's logit error against JAX (~0.03)


@pytest.mark.parametrize("route", ROUTES)
def test_engine_tokens_match_jax(model, forced_kernels, monkeypatch, route):
    """Greedy requests over two admission buckets (16, 32) and a prefix
    hit, three slots for four requests: the port's engine emits the JAX
    reference's tokens. On the megakernel and chunk routes both sides are
    the engines themselves.

    Free-running greedy sequences agree only where no decision is a near
    tie: the two sides differ by bf16 roundings (the reference under jit
    keeps some intermediates in f32), about 0.05 in the logits of this
    random model, whose top-2 margins are often smaller. On the scanned
    routes the request seed is one whose decisions clear that noise and
    the tokens are equal. On the chunk route (f32 attention, whose margins
    here fall below 0.01) a request's tokens are equal up to its first
    difference, where the port's logits must hold a near tie between the
    two tokens, and most tokens agree; the margin-gated comparison of
    every logit is test_teacher_forced_logits_match_jax."""
    cfg_j, qparams, cfg_t, tparams = model
    kw = dict(max_batch=3, max_len=MAX_LEN, chunk=4)
    if route == "unfused":
        jeng = _ScannedJEngine(qparams, cfg_j, **kw)
        teng = _ScannedTEngine(tparams, cfg_t, device="cpu", **kw)
    else:
        jeng = JEngine(qparams, cfg_j, **kw)
        teng = DecodeEngine(tparams, cfg_t, device="cpu", **kw)
        assert jeng._stacked_chunks == teng._stacked_chunks == (
            route == "megakernel")
    logits = _record_decisions(teng, monkeypatch)
    for r in _requests():
        jeng.add_request(r, max_new_tokens=6)
        teng.add_request(r, max_new_tokens=6)
    ref, out = jeng.run(), teng.run()
    assert teng.prefix_hits == jeng.prefix_hits == 1
    assert sorted(out) == sorted(ref)
    if route != "chunk":
        for rid in ref:
            assert out[rid] == [int(t) for t in ref[rid]], rid
        return
    agree = 0
    for rid in ref:
        want = [int(t) for t in ref[rid]]
        assert len(out[rid]) == len(want) == 6
        for i, (a, b) in enumerate(zip(out[rid], want)):
            if a != b:
                row = logits[rid][i]
                assert row[a] - row[b] <= NEAR_TIE, (rid, i)
                break
            agree += 1
    assert agree >= 12, agree


@pytest.mark.parametrize("route", ROUTES)
def test_teacher_forced_logits_match_jax(model, forced_kernels, route):
    """prefill_at then six decode steps (scanned, or decode_step on the
    chunk route) fed the reference's greedy tokens: logits within ATOL,
    argmax equal where the top-2 margin exceeds 2 * ATOL."""
    cfg_j, qparams, cfg_t, tparams = model
    jp = JL.quantize_llama_params(
        qparams, lambda p, lin: j_serving_layout(lin)
        if isinstance(lin, JQuant) else lin, skip=())
    tp = TL.quantize_llama_params(
        tparams, lambda p, lin: _serving_layout(lin)
        if isinstance(lin, QuantLinear) else lin, skip=())
    B, Sb = 2, 16
    toks = np.random.default_rng(3).integers(0, 512, (B, Sb)).astype(
        np.int32)
    last = np.array([9, 15], np.int32)
    off = np.zeros(B, np.int32)
    from sparsebit_tpu.llm.kv_cache import init_kv_cache as j_init

    jl, jc = JD.prefill_at(jp, jnp.asarray(toks), j_init(cfg_j, B, 32),
                           cfg_j, jnp.asarray(last), jnp.asarray(off))
    tl, tc = TD.prefill_at(tp, torch.from_numpy(toks),
                           init_kv_cache(cfg_t, B, 32, device="cpu"), cfg_t,
                           torch.from_numpy(last), torch.from_numpy(off))
    rows = [(np.asarray(jl, np.float32), tl.numpy())]
    tok = rows[0][0].argmax(-1).astype(np.int32)
    if route == "chunk":
        for _ in range(6):
            lj, jc = JD.decode_step(jp, jnp.asarray(tok), jc, cfg_j)
            lt, tc = TD.decode_step(tp, torch.from_numpy(tok), tc, cfg_t)
            rows.append((np.asarray(lj, np.float32), lt.numpy()))
            tok = rows[-1][0].argmax(-1).astype(np.int32)
    else:
        jstk, tstk = JD.stack_layers(jp), TD.stack_layers(tp)
        mega = route == "megakernel"
        jkvs = JD._scan_cache(jc, pad_scales=not mega, flat=mega)
        jlen = jc.length
        fwd = jax.jit(JD._forward_scanned_kvs,
                      static_argnames=("quant_mode", "cfg"))
        for _ in range(6):
            pos = jlen[:, None]
            mask = jnp.where(jnp.arange(32)[None, :] <= pos, 0.0, -1e9)[
                :, None, None, :]
            lj, jkvs = fwd(jstk, jnp.asarray(tok)[:, None], pos, mask, jkvs,
                           quant_mode="int8", cfg=cfg_j)
            lt = TD._forward_scanned_kvs(
                tstk, torch.from_numpy(tok)[:, None], tc.length[:, None],
                None, TD._scan_cache(tc), "int8", cfg_t)
            jlen, tc.length = jlen + 1, tc.length + 1
            rows.append((np.asarray(lj[:, 0], np.float32),
                         lt[:, 0].numpy()))
            tok = rows[-1][0].argmax(-1).astype(np.int32)
    for lj, lt in rows:
        np.testing.assert_allclose(lt, lj, atol=ATOL)
        top2 = np.sort(lj, -1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 2 * ATOL
        np.testing.assert_array_equal(lt.argmax(-1)[decisive],
                                      lj.argmax(-1)[decisive])


@pytest.mark.parametrize("route", SCANNED_ROUTES)
def test_decode_tokens_scanned_kvs_is_greedy_chunk(model, monkeypatch,
                                                   route):
    """The greedy multi-token loop over the stacked cache emits what the
    serving chunk emits at temperature 0, and advances the lengths."""
    _, _, cfg_t, tparams = model
    if route == "unfused":
        monkeypatch.setattr(TD, "FORCE_LAYER_KERNEL", False)
    tp = TD.stack_layers(TL.quantize_llama_params(
        tparams, lambda p, lin: _serving_layout(lin)
        if isinstance(lin, QuantLinear) else lin, skip=()))
    tok0 = torch.tensor([3, 77], dtype=torch.int32)
    caches = []
    for _ in range(2):
        c = init_kv_cache(cfg_t, 2, 16, device="cpu")
        c.length = torch.tensor([0, 5], dtype=torch.int32)
        caches.append(c)
    toks, _, length = TD.decode_tokens_scanned_kvs(
        tp, tok0, TD._scan_cache(caches[0]), caches[0].length, cfg_t, 3)
    ref, c = TD.decode_chunk_scanned(tp, tok0, caches[1], torch.zeros(2),
                                     torch.Generator(), cfg_t, 3)
    assert torch.equal(toks, ref)
    assert length.tolist() == c.length.tolist() == [3, 8]
    assert torch.equal(caches[0].k, caches[1].k)


def test_engine_needs_cuda_unless_cpu_is_asked(model, monkeypatch):
    _, _, cfg_t, tparams = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DecodeEngine(tparams, cfg_t)
    with pytest.raises(RuntimeError):
        DecodeEngine(tparams, cfg_t, device="cuda")


def test_prefix_hit_survives_its_admission_round(model):
    """A prefix hit is resolved before the round's first group stores new
    entries: with room for one entry, an earlier group's store must not
    evict the entry a later group hits (the reference raises a KeyError
    there, fault R6); the LRU evicts an entry nobody hit instead."""
    _, _, cfg_t, tparams = model
    eng = DecodeEngine(tparams, cfg_t, max_batch=2, max_len=MAX_LEN,
                       chunk=4, prefix_cache_size=1, device="cpu")
    rng = np.random.default_rng(11)
    a = rng.integers(0, 512, 12)
    eng.add_request(a, max_new_tokens=2)
    eng.run()
    c = eng.add_request(rng.integers(0, 512, 5), max_new_tokens=2)
    b = eng.add_request(np.concatenate([a, rng.integers(0, 512, 6)]),
                        max_new_tokens=2)
    out = eng.run()
    assert eng.prefix_hits == 1
    assert len(out[c]) == len(out[b]) == 2
    assert list(eng._prefix) == [tuple(a.tolist())]


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_serving_layout_matches_jax(bits):
    """_serving_layout (serving.py:164-189): 2/3/4-bit codes in s4r
    nibbles re-tagged bits=4 and re-padded, 8-bit keeps its "w" planes;
    bf16 qparams; impl "a8". The containers equal the reference's."""
    rng = np.random.default_rng(bits)
    K, N = 128, 600
    codes = rng.integers(0, 2 ** bits, (K, N))
    s = rng.uniform(0.01, 0.1, (2, N)).astype(np.float32)
    z = rng.integers(0, 2 ** bits, (2, N)).astype(np.float32)
    j = j_serving_layout(JQuant.from_codes(
        jnp.asarray(codes), jnp.asarray(s), jnp.asarray(z), bits, 64))
    t = _serving_layout(params_from_numpy(jax_tree_to_numpy(JQuant.from_codes(
        jnp.asarray(codes), jnp.asarray(s), jnp.asarray(z), bits, 64)),
        "cpu"))
    assert (t.bits, t.impl, t.out_features) == (j.bits, j.impl, N)
    assert sorted(t.packed) == sorted(j.packed)
    for k in j.packed:
        np.testing.assert_array_equal(t.packed[k].numpy(),
                                      np.asarray(j.packed[k]))
    np.testing.assert_array_equal(
        t.scales.view(torch.int16).numpy().view(np.uint16),
        np.asarray(j.scales).view(np.uint16))
    np.testing.assert_array_equal(t.dequantize().numpy(),
                                  np.asarray(j.dequantize()))


@pytest.mark.parametrize("route", ["chunk"])
def test_engine_serves_a_model_k4_refuses(forced_kernels, monkeypatch,
                                          route):
    """Fault B: a model the megakernel refuses (unfused projections, a
    4-bit and an 8-bit layer) decodes on decode_chunk, as the
    reference's engine does (serving.py:308-321), with the tokens of the
    JAX DecodeEngine up to near ties (see test_engine_tokens_match_jax)."""
    from sparsebit_tpu_torch.llm import serving as TS

    cfg_j = JL.llama_tiny(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=512)
    params = JL.init_llama_params(cfg_j, jax.random.PRNGKey(1))
    qparams = JL.quantize_llama_params(
        params, lambda p, lin: JQuant.from_dense(
            lin.w.astype(jnp.float32), groupsize=64,
            bits=4 if p.startswith("layers.0.") else 8))
    cfg_t = TL.llama_tiny(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=512)
    tparams = params_from_numpy(jax_tree_to_numpy(qparams), "cpu")
    chunks = []
    orig = TS.decode_chunk
    monkeypatch.setattr(TS, "decode_chunk",
                        lambda *a: chunks.append(1) or orig(*a))
    kw = dict(max_batch=3, max_len=MAX_LEN, chunk=4)
    jeng = JEngine(qparams, cfg_j, **kw)
    teng = DecodeEngine(tparams, cfg_t, device="cpu", **kw)
    assert not teng._stacked_chunks and teng.params_stacked is None
    lyr = teng.params["layers"]
    assert "s4r" in lyr[0]["wq"].packed and "w" in lyr[1]["wq"].packed
    logits = _record_decisions(teng, monkeypatch)
    for r in _requests():
        jeng.add_request(r, max_new_tokens=6)
        teng.add_request(r, max_new_tokens=6)
    ref, out = jeng.run(), teng.run()
    assert chunks and sorted(out) == sorted(ref)
    for rid in ref:
        want = [int(t) for t in ref[rid]]
        assert len(out[rid]) == len(want) == 6
        for i, (a, b) in enumerate(zip(out[rid], want)):
            if a != b:
                assert logits[rid][i][a] - logits[rid][i][b] <= NEAR_TIE
                break
