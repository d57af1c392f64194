"""The port's parallel/ (tensor-parallel serving and TPDecodeEngine; the
training half: gradients through tp's collectives, sp, pp with pipelined
QLoRA, BatchNorm and LSQ over a dp group) against the JAX package on the
CPU.

The JAX side runs on the 8-device virtual CPU mesh that conftest.py
forces; its tp_* functions and engines are jitted. The port side runs in
ONE group of four spawned ranks on gloo (tests/torch_tp_worker.py):
torchrun's variables, Mesh(dp=2, tp=2), every case on the rank's tp
group, each dp replica computing the same. Inputs are seeded numpy at
tiny widths where the s4r route (K1's plain version) is taken: dim 256,
ffn 512, 4 heads, 2 kv heads, 4-bit g64, 2 layers, f32 activations.
Tolerances are the reference's own (tests/test_parallel.py): forward
2e-4, loss rel 1e-4, decode 1e-3 (float cache) / 0.05 (int8); tokens
equal; packed shards bit-equal. The training cases
(tests/torch_train_worker.py, in the same group) run at the widths of
tests/test_parallel.py and tests/test_pp.py (dim 64, 2 or 4 layers) with
the JAX package's tolerances: losses within 1e-4 (sp 2e-4), gradients
within rtol 5e-3 / atol 5e-4 of jax.grad."""

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


# ---- the training references (tests/test_parallel.py, tests/test_pp.py) ----

TRAIN_KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                ffn_dim=128, max_seq_len=64, dtype="float32")
TRAIN4_KW = dict(TRAIN_KW, n_layers=4)
PP_CASES = [(1, 4, 4), (2, 2, 2), (1, 2, 4)]
SP_CASES = [("sp4", False), ("sp4", True), ("dp2_sp2", False),
            ("dp2_sp2", True)]
GRAD_TOL = dict(rtol=5e-3, atol=5e-4)  # tests/test_parallel.py:133-137
_COL, _ROW = ("wq", "wk", "wv", "w1", "w3", "lm_head"), ("wo", "w2")


def _bump(tree):
    """lora_B + 0.01, so that the adapters take part in the loss
    (tests/test_pp.py)."""
    def bump(x):
        if isinstance(x, JLora):
            return JLora(x.base, x.lora_A, x.lora_B + 0.01, x.alpha,
                         x.dropout)
        return x

    return jax.tree.map(bump, tree, is_leaf=lambda x: isinstance(x, JLora))


def _flat_grads(g):
    """{leaf name: array} of a JAX llama gradient tree; a TPLinear's as its
    stacked (T, ...) shards."""
    def leaf(x):
        if isinstance(x, JTP.TPLinear):
            x = x.stacked
        return np.asarray(x.w if isinstance(x, JDense) else x)

    out = {k: leaf(g[k]) for k in ("tok_embed", "norm", "lm_head")}
    for i, layer in enumerate(g["layers"]):
        for name, x in layer.items():
            out["layers.{}.{}".format(i, name)] = leaf(x)
    return out


def _shard_of(full, name, t, T):
    """Rank t's block of an unsharded gradient: columns of a
    column-parallel linear, rows of a row-parallel one."""
    kind = name.split(".")[-1]
    if kind in _COL:
        n = full.shape[1] // T
        return full[:, t * n:(t + 1) * n]
    if kind in _ROW:
        n = full.shape[0] // T
        return full[t * n:(t + 1) * n]
    return full


@pytest.fixture(scope="module")
def jax_train():
    """The JAX package's losses and gradients for the training cases, each
    program jitted once, and the numpy inputs the ranks get."""
    from sparsebit_tpu.llm.qlora import wrap_llama_lora as j_wrap_lora
    from sparsebit_tpu.parallel import pp as JPP
    from sparsebit_tpu.parallel.mesh import make_mesh_named as j_named
    from sparsebit_tpu.parallel.sp import sp_llama_loss as j_sp_loss

    cfg2, cfg4 = JL.llama_tiny(**TRAIN_KW), JL.llama_tiny(**TRAIN4_KW)
    dense2, dense4 = _rng_params(cfg2, 10), _rng_params(cfg4, 11)
    rng = np.random.default_rng(12)
    tok2 = rng.integers(0, 128, (4, 16)).astype(np.int32)
    tok4 = rng.integers(0, 128, (8, 17)).astype(np.int32)
    t2, t4 = jnp.asarray(tok2), jnp.asarray(tok4)
    ref = {}

    def vg(fn, x):
        loss, g = jax.jit(jax.value_and_grad(fn))(x)
        return float(loss), g

    ref["loss2"], g = vg(lambda p: JL.llama_loss(p, t2, cfg2), dense2)
    ref["grads2"] = _flat_grads(g)
    mesh = j_make_mesh(dp=2, tp=2)
    ref["tp_loss"], g = vg(lambda p: JTP.tp_llama_loss(p, t2, cfg2, mesh),
                           JTP.shard_llama_params_tp(dense2, cfg2, 2))
    ref["tp_grads"] = _flat_grads(g)
    for name, ring in SP_CASES:
        m = j_named(sp=4) if name == "sp4" else j_named(dp=2, sp=2)
        dp_axis = None if name == "sp4" else "dp"
        ref["sp", name, ring] = float(jax.jit(lambda p: j_sp_loss(
            p, t2, cfg2, m, dp_axis=dp_axis, ring=ring))(dense2))

    ref["loss4"], g = vg(lambda p: JL.llama_loss(p, t4, cfg4), dense4)
    ref["grads4"] = _flat_grads(g)
    for dp, pp, M in PP_CASES:
        m = j_named(dp=dp, pp=pp)
        ref["pp", dp, pp, M] = float(jax.jit(lambda p: JPP.pp_llama_loss(
            p, t4, cfg4, m, M))(JPP.stack_llama_stages(
                JPP.densify_llama_params(dense4), pp)))
    quant4 = JL.quantize_llama_params(dense4, lambda p, lin: (
        JQuant.from_dense(lin.w.astype(jnp.float32), bits=4, groupsize=32)))
    m22 = j_named(dp=2, pp=2)
    ref["pp_quant"] = float(jax.jit(lambda p: JPP.pp_llama_loss(
        p, t4, cfg4, m22, 2))(JPP.stack_llama_stages(quant4, 2)))
    qlora4 = _bump(j_wrap_lora(quant4, r=4, key=jax.random.PRNGKey(7)))
    qpp = JPP.stack_llama_stages(qlora4, 2)
    ref["pp_qlora"] = vg(lambda l: JPP.pp_qlora_loss(l, qpp, t4, cfg4, m22,
                                                      2),
                         JPP.pp_extract_lora(qpp))
    lora4 = _bump(j_wrap_lora(dense4, r=4, key=jax.random.PRNGKey(7)))
    m3 = j_named(dp=1, tp=2, pp=2)
    ptp = JPP.stack_llama_stages(JTP.shard_llama_params_tp(
        lora4, cfg4, 2, bits=4, groupsize=32), 2)
    ref["pp_tp"] = vg(lambda l: JPP.pp_tp_qlora_loss(l, ptp, t4, cfg4, m3,
                                                      2),
                      JPP.pp_extract_lora(ptp))
    data = {"cfg2": TRAIN_KW, "cfg4": TRAIN4_KW, "tokens2": tok2,
            "tokens4": tok4, "pp_cases": PP_CASES,
            "dense2": jax_tree_to_numpy(dense2),
            "dense4": jax_tree_to_numpy(dense4),
            "quant4": jax_tree_to_numpy(quant4),
            "qlora4": jax_tree_to_numpy(qlora4),
            "lora4": jax_tree_to_numpy(lora4)}
    return ref, data


@pytest.fixture(scope="module")
def port_ranks(jax_side, jax_train):
    """Every rank's results from one spawned group of four."""
    data = dict(jax_side[1], train=jax_train[1])
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


# ---- training through the collectives: tp, sp, pp --------------------------


def _assert_grads(got, want, T=1, t=0, names=None):
    for name in names or want:
        np.testing.assert_allclose(got[name], _shard_of(want[name], name, t,
                                                        T),
                                   err_msg=name, **GRAD_TOL)


def test_tp_llama_loss_gradients_match_jax(port_ranks, jax_train):
    """dp=2 x tp=2, one backward and the dp sum (mesh.sum_grads): each
    rank's loss within 1e-4 relative of JAX's tp_llama_loss, and its
    gradient of every leaf, or of its shard, within rtol 5e-3 / atol 5e-4
    of jax.grad of the unsharded llama_loss and of jax.grad of JAX's
    tp_llama_loss (shard t of its stacked TPLinear gradients)."""
    ref, _ = jax_train
    assert ref["tp_loss"] == pytest.approx(ref["loss2"], rel=1e-4)
    for res in port_ranks:
        loss, grads, t = res["train"]["tp_train"]
        assert loss == pytest.approx(ref["tp_loss"], rel=1e-4)
        assert sorted(grads) == sorted(ref["grads2"])
        _assert_grads(grads, ref["grads2"], 2, t)
        for name, want in ref["tp_grads"].items():
            kind = name.split(".")[-1]
            want = want[t] if kind in _COL + _ROW else want
            np.testing.assert_allclose(grads[name], want, err_msg=name,
                                       **GRAD_TOL)


@pytest.mark.parametrize("mesh,ring", SP_CASES)
def test_sp_llama_loss_and_gradients_match_jax(port_ranks, jax_train, mesh,
                                               ring):
    """sp=4 and dp=2 x sp=2, the K/V all_gather and the ring: every rank's
    loss within 2e-4 of JAX's jitted sp_llama_loss and, after the sum over
    sp (and dp), its gradients within rtol 5e-3 / atol 5e-4 of JAX's
    single-device llama_loss gradients."""
    ref, _ = jax_train
    for res in port_ranks:
        loss, grads = res["train"]["sp", mesh, ring]
        assert loss == pytest.approx(ref["sp", mesh, ring], rel=2e-4)
        assert loss == pytest.approx(ref["loss2"], rel=2e-4)
        _assert_grads(grads, ref["grads2"])


@pytest.mark.parametrize("dp,pp,M", PP_CASES)
def test_pp_llama_loss_and_gradients_match_jax(port_ranks, jax_train, dp,
                                               pp, M):
    """GPipe waves over the densified float model (a (1, pp) mesh smaller
    than the group repeats over a replica axis): the loss within 1e-4 of
    JAX's pp_llama_loss on every rank; after pp_sum_grads each rank's
    gradients of its stage and of the replicated embedding, norm and head
    within rtol 5e-3 / atol 5e-4 of JAX's single-device ones."""
    ref, _ = jax_train
    n_layers = TRAIN4_KW["n_layers"]
    seen = set()
    for res in port_ranks:
        loss, grads = res["train"]["pp", dp, pp, M]
        assert loss == pytest.approx(ref["pp", dp, pp, M], rel=1e-4)
        assert loss == pytest.approx(ref["loss4"], rel=1e-4)
        _assert_grads(grads, ref["grads4"], names=list(grads))
        seen.update(k for k in grads if k.startswith("layers."))
    assert len(seen) == 9 * n_layers  # every layer's leaves on some rank


def test_pp_quantized_backbone_matches_jax(port_ranks, jax_train):
    """(dp, pp, M) = (2, 2, 2) over the 4-bit g32 backbone: within 1e-4 of
    JAX's pp_llama_loss."""
    ref, _ = jax_train
    for res in port_ranks:
        assert res["train"]["pp_quant"] == pytest.approx(ref["pp_quant"],
                                                         rel=1e-4)


def _lora_ref(tree, key, tp=None):
    """JAX's stacked adapter gradient for the port's (stage, layer, name)
    key. ``tp``: the rank's part of a TPLinear's. JAX stacks a copy of the
    replicated factor (lora_A of a column split, lora_B of a row split) a
    shard, and each copy's gradient is that shard's share: the unsharded
    model's gradient of the factor is their sum."""
    s, i, name = key
    node = tree["stages"][name]
    if tp is not None:
        node = node.stacked
    a, b = (np.asarray(node[k])[s, i] for k in ("lora_A", "lora_B"))
    if tp is None:
        return a, b
    if name in _COL:
        return a.sum(axis=0), b[tp]
    return a[tp], b.sum(axis=0)


def test_pp_qlora_loss_and_gradients_match_jax(port_ranks, jax_train):
    """Pipelined QLoRA over the packed 4-bit backbone on (dp=2, pp=2):
    the loss within 1e-4 of JAX's pp_qlora_loss, each rank's stage's
    adapter gradients (after the dp sum) within rtol 5e-3 / atol 5e-4 of
    jax.grad of it."""
    ref, _ = jax_train
    loss_ref, g_ref = ref["pp_qlora"]
    for res in port_ranks:
        got = res["train"]["pp_qlora"]
        assert got["loss"] == pytest.approx(loss_ref, rel=1e-4)
        assert sorted({k[0] for k in got["grads"]}) == [got["sid"]]
        assert len(got["grads"]) == 2 * 2  # two layers x (wq, wv)
        for key, (a, b) in got["grads"].items():
            wa, wb = _lora_ref(g_ref, key)
            np.testing.assert_allclose(a, wa, **GRAD_TOL)
            np.testing.assert_allclose(b, wb, **GRAD_TOL)


def test_pp_qlora_train_step_moves_only_the_adapters(port_ranks):
    """One pp_qlora_train_step (Adam, lr 1e-2; tests/test_pp.py:122-143):
    the loss falls, the packed backbone is untouched, and the adapters
    merged back (pp_merge_lora) give the same loss through pp_llama_loss
    within 1e-5."""
    for res in port_ranks:
        got = res["train"]["pp_qlora"]
        assert got["loss_after"] < got["loss"]
        assert got["backbone_equal"]
        assert got["merged"] == pytest.approx(got["loss_after"], rel=1e-5)


def test_pp_tp_qlora_matches_jax(port_ranks, jax_train):
    """dp=1 x tp=2 x pp=2 QLoRA over packed tensor-parallel stages: the
    loss within 1e-4 of JAX's pp_tp_qlora_loss on the same mesh, each
    rank's adapter gradients (its stage; of wq and wv, column splits,
    lora_B's block and the whole of the replicated lora_A, summed over the
    ranks in the backward by _copy_to) within rtol 5e-3 / atol 5e-4 of
    jax.grad of it."""
    ref, _ = jax_train
    loss_ref, g_ref = ref["pp_tp"]
    for res in port_ranks:
        loss, grads, sid, t = res["train"]["pp_tp"]
        assert loss == pytest.approx(loss_ref, rel=1e-4)
        assert sorted({k[0] for k in grads}) == [sid] and len(grads) == 4
        for key, (a, b) in grads.items():
            wa, wb = _lora_ref(g_ref, key, tp=t)
            np.testing.assert_allclose(a, wa, **GRAD_TOL)
            np.testing.assert_allclose(b, wb, **GRAD_TOL)


def test_shard_packed_keeps_qlora_base_codes(model):
    """shard_llama_params_tp_packed over QLoRA params (adapters on wq and
    wv over packed QuantLinears): each rank's base shard is
    shard_quantlinear's exact one, lora_A whole and lora_B's columns
    split (column-parallel), the other linears split as before."""
    from sparsebit_tpu_torch.llm.qlora import wrap_llama_lora

    _, _, qparams = model
    cfg = TL.llama_tiny(**CFG_KW)
    q = wrap_llama_lora(params_from_numpy(jax_tree_to_numpy(qparams), "cpu"),
                        r=4, generator=torch.Generator().manual_seed(3))
    for layer in q["layers"]:
        layer["wq"].lora_B += 0.5
    tp = TTP.shard_llama_params_tp_packed(q, cfg, 2)
    for name in ("wq", "wv"):
        lin, got = q["layers"][0][name], tp["layers"][0][name]
        want = TTP.shard_quantlinear(lin.base, 2, "col")
        n = lin.lora_B.shape[1] // 2
        for t in range(2):
            sh = got.shards[t]
            assert isinstance(sh, LoraLinear) and got.kind == "col"
            for k, v in want.shards[t].packed.items():
                assert torch.equal(sh.base.packed[k], v)
            assert torch.equal(sh.lora_A, lin.lora_A)
            assert torch.equal(sh.lora_B, lin.lora_B[:, t * n:(t + 1) * n])
    assert isinstance(tp["layers"][0]["wo"].shards[0], QuantLinear)


def test_dp_batchnorm_and_lsq_take_the_global_batch(port_ranks):
    """Within nn.data_parallel (dp=2), BatchNorm2d in training
    mode on a rank's rows gives that rank's rows of the whole batch's
    output, the whole batch's running statistics and, after the sum over
    dp, its gamma / beta gradients and the rank's rows of the input
    gradient (the statistics' all_reduce sums their gradient too), each
    within 1e-5 relative; LSQ's gradient scale counts a feature over the
    global batch (2x the rank's elements) and a weight as it is. The JAX
    package's jitted step sees the global batch, so both match it."""
    for res in port_ranks:
        got = res["train"]["dp_batchnorm"]
        for k in ("out", "running_mean", "running_var", "weight_grad",
                  "bias_grad", "x_grad"):
            assert got[k] <= 1e-5, (k, got[k])
        n = got["local_elements"]
        assert got["lsq_counts"] == (2 * n, n)
