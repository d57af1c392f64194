"""The port's tensor-parallel serving (sparsebit_tpu_torch/parallel and
TPDecodeEngine) against the JAX package on the CPU.

The JAX side runs on the 8-device virtual CPU mesh that conftest.py
forces; its tp_* functions and engines are jitted. The port side runs in
ONE group of four spawned ranks on gloo (tests/torch_tp_worker.py):
torchrun's variables, Mesh(dp=2, tp=2), every case on the rank's tp
group, each dp replica computing the same. Inputs are seeded numpy at
tiny widths where the s4r route (K1's plain version) is taken: dim 256,
ffn 512, 4 heads, 2 kv heads, 4-bit g64, 2 layers, f32 activations.
Tolerances are the reference's own (tests/test_parallel.py): forward
2e-4, loss rel 1e-4, decode 1e-3 (float cache) / 0.05 (int8); tokens
equal; packed shards bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.decode import prefill as j_prefill
from sparsebit_tpu.llm.kv_cache import init_kv_cache as j_init_kv_cache
from sparsebit_tpu.llm.qlora import LoraLinear as JLora
from sparsebit_tpu.llm.quant import DenseLinear as JDense
from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu.llm.serving import TPDecodeEngine as JTPEngine
from sparsebit_tpu.llm.serving import _serving_layout as j_serving_layout
from sparsebit_tpu.parallel import tp as JTP
from sparsebit_tpu.parallel.mesh import make_mesh as j_make_mesh
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.qlora import LoraLinear
from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear
from sparsebit_tpu_torch.llm.serving import DecodeEngine, TPDecodeEngine
from sparsebit_tpu_torch.parallel import tp as TTP
from sparsebit_tpu_torch.parallel.multihost import free_port, spawn_ranks
from test_torch_engine import jax_tree_to_numpy
from torch_tp_worker import run as worker_run

torch.set_num_threads(1)

CFG_KW = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
              ffn_dim=512, max_seq_len=64, dtype="float32")
GS = 64
WORLD = 4  # Mesh(dp=2, tp=2)
PROMPTS = [np.array([3, 17, 91, 30, 7], np.int32),
           np.array([5, 9], np.int32),
           np.array([8, 1, 2, 3, 4, 5], np.int32)]
EXTENSION = np.concatenate([PROMPTS[0], [17, 4]]).astype(np.int32)


def _rng_params(cfg, seed):
    """Seeded numpy weights in the JAX package's tree (N(0, 0.02)
    linears, unit norms, untied head), as JAX DenseLinears."""
    rng = np.random.default_rng(seed)
    hd = cfg.head_dim

    def lin(K, N):
        return JDense(jnp.asarray(rng.normal(0, 0.02, (K, N)), jnp.float32))

    layers = [{
        "attn_norm": jnp.ones((cfg.dim,), jnp.float32),
        "ffn_norm": jnp.ones((cfg.dim,), jnp.float32),
        "wq": lin(cfg.dim, cfg.n_heads * hd),
        "wk": lin(cfg.dim, cfg.n_kv_heads * hd),
        "wv": lin(cfg.dim, cfg.n_kv_heads * hd),
        "wo": lin(cfg.n_heads * hd, cfg.dim),
        "w1": lin(cfg.dim, cfg.ffn_dim), "w3": lin(cfg.dim, cfg.ffn_dim),
        "w2": lin(cfg.ffn_dim, cfg.dim),
    } for _ in range(cfg.n_layers)]
    return {"tok_embed": jnp.asarray(rng.normal(0, 0.02, (cfg.vocab_size,
                                                           cfg.dim)),
                                     jnp.float32),
            "layers": layers, "norm": jnp.ones((cfg.dim,), jnp.float32),
            "lm_head": lin(cfg.dim, cfg.vocab_size)}


def _quantize(params):
    return JL.quantize_llama_params(
        params, lambda p, lin: JQuant.from_dense(
            lin.w.astype(jnp.float32), bits=4, groupsize=GS))


def _cache_np(c):
    """A JAX KVCache as the layer-stacked numpy dict the port reads."""
    st = (lambda xs: np.stack([np.asarray(x) for x in xs])
          if xs else None)
    return {"k": st(c.k), "v": st(c.v), "k_scale": st(c.k_scale),
            "v_scale": st(c.v_scale), "length": np.asarray(c.length),
            "quantized": "int8" if c.quantized else False}


@pytest.fixture(scope="module")
def model():
    cfg = JL.llama_tiny(**CFG_KW)
    dense = _rng_params(cfg, 0)
    return cfg, dense, _quantize(dense)


@pytest.fixture(scope="module")
def jax_side(model):
    """The JAX package's results on the inputs the ranks get."""
    cfg, dense, qparams = model
    out, data = {}, {"cfg": CFG_KW}
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    mesh = j_make_mesh(dp=2, tp=2)
    dtp = JTP.shard_llama_params_tp(dense, cfg, 2)
    out["forward"] = np.asarray(JTP.tp_llama_forward(dtp, jnp.asarray(tokens),
                                                     cfg, mesh))
    out["loss"] = float(JTP.tp_llama_loss(dtp, jnp.asarray(tokens), cfg,
                                          mesh))
    data.update(tokens=tokens, dense=jax_tree_to_numpy(dense),
                quant=jax_tree_to_numpy(qparams))

    mesh_tp = j_make_mesh(dp=1, tp=2)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 5)), jnp.int32)
    data["decode"] = {}
    for mode, quantized in (("float", False), ("int8", True)):
        cache = j_init_kv_cache(cfg, 2, 16, quantized=quantized)
        logits, cache = j_prefill(dense, prompt, cache, cfg)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        case = {"cache": _cache_np(cache), "tok": np.asarray(tok)}
        ctp = JTP.shard_kv_cache_tp(cache, mesh_tp)
        l1, ctp = JTP.tp_decode_step(dtp, tok, ctp, cfg, mesh_tp)
        tok2 = jnp.argmax(l1, -1).astype(jnp.int32)
        l2, ctp = JTP.tp_decode_step(dtp, tok2, ctp, cfg, mesh_tp)
        case["tok2"] = np.asarray(tok2)
        data["decode"][mode] = case
        out["decode_" + mode] = ([np.asarray(l1), np.asarray(l2)],
                                 np.asarray(ctp.length))

    qtp = JTP.shard_llama_params_tp_packed(qparams, cfg, 2,
                                           conv=j_serving_layout)
    toks = np.zeros((3, 16), np.int32)
    lens = [7, 16, 11]
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    pa = {"tokens": toks, "last_idx": np.array([n - 1 for n in lens],
                                               np.int32),
          "offset": np.zeros(3, np.int32), "max_len": 32, "n_tokens": 6}
    cache = JTP.shard_kv_cache_tp(j_init_kv_cache(cfg, 3, 32, True), mesh_tp)
    logits, cache = JTP.tp_prefill_at(
        qtp, jnp.asarray(toks), cache, cfg, jnp.asarray(pa["last_idx"]),
        jnp.asarray(pa["offset"]), mesh_tp)
    tok0 = jnp.argmax(logits, -1).astype(jnp.int32)
    chunk, cache = JTP.tp_decode_chunk(
        qtp, tok0, cache, jnp.zeros((3,), jnp.float32),
        jax.random.PRNGKey(0), cfg, mesh_tp, pa["n_tokens"])
    out["prefill_at"] = (np.asarray(logits), np.asarray(tok0),
                         np.asarray(chunk), np.asarray(cache.length))
    data["prefill_at"] = pa

    eng = JTPEngine(qparams, cfg, mesh_tp, max_batch=2, max_len=48)
    rids = [eng.add_request(p, max_new_tokens=5) for p in PROMPTS]
    got = eng.run()
    ext = eng.add_request(EXTENSION, max_new_tokens=4)
    got2 = eng.run()
    out["engine"] = ([[int(t) for t in got[i]] for i in rids],
                     [int(t) for t in got2[ext]], eng.prefix_hits)
    data.update(prompts=PROMPTS, extension=EXTENSION)
    return out, data


@pytest.fixture(scope="module")
def port_ranks(jax_side):
    """Every rank's results from one spawned group of four."""
    _, data = jax_side
    return spawn_ranks(worker_run, WORLD, args=(WORLD, free_port(), data))


# ---- shards (in-process) ----------------------------------------------------


def _shard_leaves(lin):
    if isinstance(lin, (JLora, LoraLinear)):
        return dict(_shard_leaves(lin.base), lora_A=np.asarray(lin.lora_A),
                    lora_B=np.asarray(lin.lora_B))
    if isinstance(lin, (JQuant, QuantLinear)):
        leaves = dict(lin.packed, scales=lin.scales, zeros=lin.zeros)
    else:
        leaves = {"w": lin.w}
    if lin.bias is not None:
        leaves["bias"] = lin.bias
    return {k: np.asarray(v) for k, v in leaves.items()}


def _assert_shards_equal(jtl, ttl, T):
    assert ttl.kind == jtl.kind and sorted(ttl.shards) == list(range(T))
    for t in range(T):
        want = _shard_leaves(jax.tree.map(lambda a: a[t], jtl.stacked))
        got = _shard_leaves(ttl.shards[t])
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["col", "row"])
def test_shard_quantlinear_bit_equal_to_jax(model, kind):
    """Packed codes, scales and zeros of every rank's exact shard equal
    JAX's TPLinear.stacked[t], with a bias (1/T of it a row shard)."""
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.02, (256, 512)).astype(np.float32)
    b = rng.normal(0, 0.1, 512).astype(np.float32)
    jl = JQuant.from_dense(jnp.asarray(w), bits=4, groupsize=GS,
                           bias=jnp.asarray(b))
    tl = params_from_numpy(jax_tree_to_numpy(jl), "cpu")
    _assert_shards_equal(JTP.shard_quantlinear(jl, 2, kind),
                         TTP.shard_quantlinear(tl, 2, kind), 2)
    one = TTP.shard_quantlinear(tl, 2, kind, rank=1)
    assert sorted(one.shards) == [1]
    np.testing.assert_array_equal(
        one.local().packed["w"].numpy(),
        TTP.shard_quantlinear(tl, 2, kind).shards[1].packed["w"].numpy())


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("kind", ["col", "row"])
def test_shard_linear_bit_equal_to_jax(kind, bits):
    """shard_linear of a dense linear: the plain split, and each shard
    quantized on its own at 8 bits (g64)."""
    w = np.random.default_rng(3).normal(0, 0.02, (256, 512)).astype(
        np.float32)
    jt = JTP.shard_linear(JDense(jnp.asarray(w)), 2, kind, bits, GS)
    tt = TTP.shard_linear(DenseLinear(torch.from_numpy(w)), 2, kind, bits,
                          GS)
    _assert_shards_equal(jt, tt, 2)


@pytest.mark.parametrize("kind", ["col", "row"])
def test_shard_linear_lora_bit_equal_to_jax(kind):
    """A LoraLinear over a 4-bit g64 base: the base split and requantized
    per shard, lora_B's columns (col) or lora_A's rows (row) split, the
    other adapter whole."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.02, (256, 512)).astype(np.float32)
    a = rng.normal(0, 0.1, (256, 8)).astype(np.float32)
    b = rng.normal(0, 0.1, (8, 512)).astype(np.float32)
    jb = JQuant.from_dense(jnp.asarray(w), bits=4, groupsize=GS)
    jl = JLora(jb, jnp.asarray(a), jnp.asarray(b), 16.0)
    tl = LoraLinear(params_from_numpy(jax_tree_to_numpy(jb), "cpu"),
                    torch.from_numpy(a), torch.from_numpy(b), 16.0)
    _assert_shards_equal(JTP.shard_linear(jl, 2, kind, 4, GS),
                         TTP.shard_linear(tl, 2, kind, 4, GS), 2)


def test_shards_refuse_misaligned_rows_and_perm(model):
    """Both packages refuse a row shard that cuts a group (K/T = 32 of
    g64) and a row split of an act-order (perm) linear."""
    _, _, qparams = model
    jl = qparams["layers"][0]["wo"]
    tl = params_from_numpy(jax_tree_to_numpy(jl), "cpu")
    with pytest.raises(AssertionError, match="not aligned"):
        JTP.shard_quantlinear(jl, 8, "row")
    with pytest.raises(ValueError, match="not aligned"):
        TTP.shard_quantlinear(tl, 8, "row")
    perm = np.random.default_rng(4).permutation(256).astype(np.int32)
    jp = JQuant(jl.packed, jl.scales, jl.zeros, jl.bits, jl.groupsize,
                jl.out_features, perm=jnp.asarray(perm))
    tp_ = tl._replace(perm=torch.from_numpy(perm))
    with pytest.raises(AssertionError, match="perm"):
        JTP.shard_quantlinear(jp, 2, "row")
    with pytest.raises(ValueError, match="perm"):
        TTP.shard_quantlinear(tp_, 2, "row")
    with pytest.raises(ValueError, match="not aligned"):
        TTP.shard_linear(DenseLinear(torch.zeros(256, 8)), 8, "row", bits=4,
                         groupsize=GS)


def test_tp_engine_needs_cuda_unless_cpu_is_asked(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPDecodeEngine({}, TL.llama_tiny(**CFG_KW), None)


# ---- the spawned group ------------------------------------------------------


def test_mesh_and_multihost_partition_the_batch(port_ranks):
    """initialize_multihost() joined through torchrun's variables; each
    rank's local_batch_slice / dp_shard_batch rows: contiguous, the same
    within a tp pair, and together the whole batch; replicate broadcast
    rank 0's leaves to every rank."""
    rows = {}
    for rank, res in enumerate(port_ranks):
        assert res["joined"] == (rank, WORLD)
        assert res["replicated"] == ([0.0, 0.0, 0.0], [0, 1])
        sl = res["batch_slice"]
        assert res["dp_rows"] == list(range(8))[sl]
        assert res["tp_rank"] == rank % 2
        rows.setdefault(rank // 2, res["dp_rows"])
        assert rows[rank // 2] == res["dp_rows"]
    assert sorted(rows[0] + rows[1]) == list(range(8))
    assert rows[0] == [0, 1, 2, 3]


def test_tp_llama_forward_and_loss_match_jax(port_ranks, jax_side):
    """dp=2 x tp=2: every rank's rows of the gathered logits within 2e-4
    of JAX's tp_llama_forward, the loss within rel 1e-4 on every rank."""
    ref, _ = jax_side
    for rank, res in enumerate(port_ranks):
        rows = slice((rank // 2) * 2, (rank // 2) * 2 + 2)
        np.testing.assert_allclose(res["forward"], ref["forward"][rows],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(res["loss"], ref["loss"], rtol=1e-4)


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_tp_decode_step_matches_jax(port_ranks, jax_side, mode):
    """Two tp_decode_steps from JAX's prefilled cache: each rank's vocab
    shard of the logits within 1e-3 (float cache) / 0.05 (int8) of JAX's,
    cache lengths equal."""
    ref, _ = jax_side
    tol = 0.05 if mode == "int8" else 1e-3
    want_steps, want_len = ref["decode_" + mode]
    for res in port_ranks:
        steps, length = res["decode_" + mode]
        r = res["tp_rank"]
        for got, want in zip(steps, want_steps):
            V = want.shape[1] // 2
            np.testing.assert_allclose(got, want[:, r * V: (r + 1) * V],
                                       rtol=tol, atol=tol)
        np.testing.assert_array_equal(length, want_len)


def test_tp_prefill_at_and_decode_chunk_match_jax(port_ranks, jax_side):
    """Bucketed prefill (ragged rows) over the packed serving shards, then
    six greedy tokens of tp_decode_chunk: gathered logits within 1e-3 of
    JAX's, tokens and lengths equal, the same on every rank."""
    ref, _ = jax_side
    w_logits, w_tok0, w_toks, w_len = ref["prefill_at"]
    for res in port_ranks:
        logits, tok0, toks, length = res["prefill_at"]
        np.testing.assert_allclose(logits, w_logits, rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(tok0, w_tok0)
        np.testing.assert_array_equal(toks, w_toks)
        np.testing.assert_array_equal(length, w_len)
        np.testing.assert_array_equal(logits, port_ranks[0]["prefill_at"][0])


def test_tp_engine_matches_jax_and_the_port_engine(model, port_ranks,
                                                   jax_side):
    """TPDecodeEngine at tp=2 (two slots, three requests, then a request
    that extends a served prompt): every rank's tokens equal JAX's
    TPDecodeEngine's and the port's one-device DecodeEngine's, with one
    prefix hit; the megakernel route stays off and the slot cache holds
    the rank's kv head."""
    cfg, _, qparams = model
    ref, data = jax_side
    eng = DecodeEngine(params_from_numpy(data["quant"], "cpu"),
                       TL.llama_tiny(**CFG_KW), max_batch=2, max_len=48,
                       device="cpu")
    rids = [eng.add_request(p, max_new_tokens=5) for p in PROMPTS]
    one = eng.run()
    ext = eng.add_request(EXTENSION, max_new_tokens=4)
    one2 = eng.run()
    j_toks, j_ext, j_hits = ref["engine"]
    assert j_hits == 1 and eng.prefix_hits == 1
    assert [one[i] for i in rids] == j_toks and one2[ext] == j_ext
    for res in port_ranks:
        toks, ext_toks, hits, off, cache_shape = res["engine"]
        assert toks == j_toks and ext_toks == j_ext and hits == 1
        assert off
        assert cache_shape == (cfg.n_layers, 2, 48, cfg.n_kv_heads // 2,
                               cfg.head_dim)
