"""The port's GPTQ (``sparsebit_tpu_torch/llm/gptq.py`` and
``convert.quantize_llama_gptq``) against the JAX package's, on the CPU.

The same seeded numpy inputs go through both solvers. Tolerances:
- Hessians and means: max |a - b| <= 1e-5 * max |b| (f32 sums of XᵀX in
  another order);
- the inverse-Hessian factor U: rtol 1e-4, atol 1e-5 * max |U|
  (cholesky_inverse against cho_solve);
- the solver: codes, the bit choice and the act-order perm equal (at these
  sizes no rounding tie flips a code); scales, zeros and wq within 1e-5 *
  max |w|, the loss within rtol 1e-4;
- a converted tiny LLaMA: layers_bit equal, at least 99.5 % of the codes
  equal (a code flipped by a rounding tie changes the error that later
  columns and layers see), dequantized weights within one quantization
  step of each group, logits of the two converted models within atol 2e-2
  (their f32 logits are O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import gptq as JG
from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.convert import load_quant_checkpoint as j_load
from sparsebit_tpu.llm.convert import quantize_llama_gptq as j_gptq
from sparsebit_tpu.llm.convert import save_quant_checkpoint as j_save
from sparsebit_tpu_torch.llm import gptq as TG
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import (
    load_quant_checkpoint,
    params_from_numpy,
    quantize_llama_gptq,
    save_quant_checkpoint,
)
from sparsebit_tpu_torch.llm.quant import QuantLinear

from test_torch_engine import jax_tree_to_numpy

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _activations(K, rows, seed, dead=()):
    """Correlated activations (a non-diagonal Hessian, where GPTQ wins
    over round to nearest), with the columns in ``dead`` always 0."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((rows, K // 4)).astype(np.float32)
    x = np.tile(base, (1, 4)) + 0.1 * rng.standard_normal(
        (rows, K)).astype(np.float32)
    x[:, list(dead)] = 0.0
    return x


def _hessian(x):
    acc = TG.HessianAccumulator(x.shape[1], device="cpu")
    acc.add_batch(_t(x))
    return acc


def test_hessian_accumulator_matches_jax():
    """Three batches of 50, 7 and 2 x 40 rows (one of them 3-D): H,
    mean_x and the row count."""
    x = _activations(64, 137, 0)
    batches = [x[:50], x[50:57], x[57:].reshape(2, 40, 64)]
    ja = JG.HessianAccumulator(64)
    ta = TG.HessianAccumulator(64, device="cpu")
    for b in batches:
        ja.add_batch(jnp.asarray(b))
        ta.add_batch(_t(b))
    assert ta.nsamples == ja.nsamples == 137
    for got, ref in ((ta.H, ja.H), (ta.mean_x, ja.mean_x)):
        ref = np.asarray(ref)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_hinv_cholesky_dead_columns():
    """Dead columns (diag 0) get diag 1 before the damp; U is upper with
    U^T U the inverse of the damped H."""
    x = _activations(64, 256, 1, dead=(3, 40))
    H = _hessian(x).H
    U, dead = TG._hinv_cholesky(H, 0.01)
    Uj, deadj = JG._hinv_cholesky(jnp.asarray(H.numpy()), 0.01)
    assert dead.tolist() == np.asarray(deadj).tolist()
    assert dead.nonzero().flatten().tolist() == [3, 40]
    Uj = np.asarray(Uj)
    np.testing.assert_allclose(U.numpy(), Uj, rtol=1e-4,
                               atol=1e-5 * np.abs(Uj).max())
    assert torch.equal(U, torch.triu(U))
    Hd = H.clone().double()
    Hd.diagonal().add_(dead.double())
    Hd.diagonal().add_(0.01 * Hd.diagonal().mean())
    eye = (U.double().t() @ U.double()) @ Hd
    np.testing.assert_allclose(eye.numpy(), np.eye(64), atol=1e-3)


# (K, N, bits, groupsize, blocksize, sym, act_order, bias, dead columns)
SOLVER_CASES = [
    (64, 32, 2, 32, 32, False, False, False, ()),
    (128, 48, 3, 32, 128, False, False, True, ()),
    (128, 32, 4, -1, 64, False, False, False, ()),
    (64, 32, 4, 32, 32, True, False, False, ()),
    # act-order with a tied diagonal: the dead columns all have diag 0
    (128, 32, 4, 32, 32, False, True, False, (5, 17, 90)),
    (128, 40, 3, -1, 128, False, True, True, (0, 64)),
]


@pytest.mark.parametrize("case", SOLVER_CASES, ids=[
    "b{}_g{}_bs{}{}{}{}".format(c[2], c[3], c[4], "_sym" if c[5] else "",
                                "_ao" if c[6] else "", "_bias" if c[7]
                                else "") for c in SOLVER_CASES])
def test_gptq_quantize_matches_jax(case):
    K, N, bits, gs, bs, sym, ao, with_bias, dead = case
    rng = np.random.default_rng(K + N + bits)
    w = (rng.standard_normal((K, N)) * 0.5).astype(np.float32)
    x = _activations(K, 512, bits, dead) + 0.5  # nonzero mean for bias
    acc = _hessian(x)
    H, mean_x = acc.H.numpy(), acc.mean_x.numpy()
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    kw = dict(bits=bits, groupsize=gs, blocksize=bs, sym=sym, act_order=ao)
    extra_j = dict(mean_x=jnp.asarray(mean_x), bias=jnp.asarray(bias)) \
        if with_bias else {}
    extra_t = dict(mean_x=_t(mean_x), bias=_t(bias)) if with_bias else {}
    ref = JG.gptq_quantize(jnp.asarray(w), jnp.asarray(H), **kw, **extra_j)
    got = TG.gptq_quantize(_t(w), _t(H), **kw, **extra_t)
    assert got["bits"] == ref["bits"] == bits
    if ao:
        perm = np.asarray(ref["perm"])
        np.testing.assert_array_equal(got["perm"].numpy(), perm)
        # the tied (dead) rows keep their order at the end
        assert perm[-len(dead):].tolist() == sorted(dead)
    else:
        assert got["perm"] is None and ref["perm"] is None
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(ref["codes"]))
    atol = 1e-5 * np.abs(w).max()
    for key in ("scales", "zeros", "wq") + (("bias",) if with_bias else ()):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=atol, err_msg=key)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    # the packed linear reproduces wq (perm applied to x at matmul time)
    qlin = QuantLinear.from_codes(got["codes"], got["scales"], got["zeros"],
                                  bits, gs, perm=got["perm"])
    np.testing.assert_allclose(qlin.dequantize().numpy(),
                               got["wq"].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("threshold,want", [(1e-6, 4), (1.0, 2)])
def test_gptq_quantize_mixed_bits(threshold, want):
    """The first candidate under the threshold, else the last: the same
    choice and codes as the JAX package's."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((64, 16)) * 0.1).astype(np.float32)
    H = _hessian(rng.standard_normal((512, 64)).astype(np.float32)).H
    kw = dict(candidate_bits=(2, 4), loss_threshold=threshold, groupsize=32,
              blocksize=32)
    got = TG.gptq_quantize_mixed(_t(w), H, **kw)
    ref = JG.gptq_quantize_mixed(jnp.asarray(w), jnp.asarray(H.numpy()),
                                 **kw)
    assert got["bits"] == ref["bits"] == want
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(ref["codes"]))


def test_gptq_beats_rtn_on_hessian_loss():
    """tests/test_llm.py:62-91 on the port: GPTQ's error propagation beats
    round to nearest on the Hessian-weighted output error, and its codes
    and scales reconstruct wq."""
    rng = np.random.default_rng(4)
    w = _t((rng.standard_normal((64, 32)) * 0.5).astype(np.float32))
    x = _t(_activations(64, 2048, 5))
    acc = TG.HessianAccumulator(64, device="cpu")
    acc.add_batch(x)
    res = TG.gptq_quantize(w, acc.H, bits=3, groupsize=32, blocksize=32)
    rtn = QuantLinear.from_dense(w, bits=3, groupsize=32)
    err_gptq = ((x @ res["wq"] - x @ w) ** 2).mean().item()
    err_rtn = ((x @ rtn.dequantize() - x @ w) ** 2).mean().item()
    assert err_gptq < err_rtn, (err_gptq, err_rtn)
    qlin = QuantLinear.from_codes(res["codes"], res["scales"], res["zeros"],
                                  3, 32)
    np.testing.assert_allclose(qlin.dequantize().numpy(), res["wq"].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_gptq_bias_correction():
    """tests/test_llm.py:110-127 on the port: the corrected bias shrinks
    the mean output error."""
    rng = np.random.default_rng(9)
    w = _t(rng.standard_normal((32, 8)).astype(np.float32))
    x = _t(rng.standard_normal((256, 32)).astype(np.float32) + 1.0)
    acc = TG.HessianAccumulator(32, device="cpu")
    acc.add_batch(x)
    res = TG.gptq_quantize(w, acc.H, bits=2, groupsize=-1, blocksize=32,
                           mean_x=acc.mean_x, bias=torch.zeros(8))
    err_plain = (x @ res["wq"] - x @ w).mean(0).abs().mean()
    err_corr = (x @ res["wq"] + res["bias"] - x @ w).mean(0).abs().mean()
    assert err_corr.item() < err_plain.item()


def test_gptq_act_order():
    """tests/test_llm.py:286-310 on the port: act-order does not hurt on
    heterogeneous channel salience, and the permuted QuantLinear
    reproduces wq."""
    rng = np.random.default_rng(30)
    w = _t((rng.standard_normal((64, 32)) * 0.5).astype(np.float32))
    x = _t((rng.standard_normal((1024, 64)) * (np.arange(64) / 64 + 0.1))
           .astype(np.float32))
    acc = TG.HessianAccumulator(64, device="cpu")
    acc.add_batch(x)
    std = TG.gptq_quantize(w, acc.H, bits=2, groupsize=32, blocksize=32)
    ao = TG.gptq_quantize(w, acc.H, bits=2, groupsize=32, blocksize=32,
                          act_order=True)
    err_std = ((x @ std["wq"] - x @ w) ** 2).mean().item()
    err_ao = ((x @ ao["wq"] - x @ w) ** 2).mean().item()
    assert err_ao <= err_std * 1.1, (err_ao, err_std)
    qlin = QuantLinear.from_codes(ao["codes"], ao["scales"], ao["zeros"], 2,
                                  32, perm=ao["perm"])
    np.testing.assert_allclose(qlin.dequantize().numpy(), ao["wq"].numpy(),
                               rtol=1e-5, atol=1e-5)


# ---- the layer-streaming conversion ------------------------------------


def _tiny(**kw):
    d = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=256, max_seq_len=64, dtype="float32")
    d.update(kw)
    return JL.llama_tiny(**d), TL.llama_tiny(**d)


@pytest.fixture(scope="module")
def tiny_model():
    """A tiny f32 LLaMA made by the JAX package, in both layouts, its
    weights carried across; 4 calibration samples of 32 tokens."""
    cfg_j, cfg_t = _tiny()
    params = JL.init_llama_params(cfg_j, jax.random.PRNGKey(0), scale=0.1)
    calib = np.random.default_rng(3).integers(0, 256, (4, 32)).astype(
        np.int32)
    return cfg_j, cfg_t, params, calib


def _assert_converted_equal(qt, qj, bits_t, bits_j, cfg_t, cfg_j):
    assert bits_t == bits_j
    pairs = [("lm_head", qt["lm_head"], qj["lm_head"])]
    for lt, lj in zip(qt["layers"], qj["layers"]):
        assert sorted(lt) == sorted(lj)
        pairs += [(name, lin, lj[name]) for name, lin in lt.items()]
    n_codes = n_equal = 0
    for name, lin, ref in pairs:
        if isinstance(lin, QuantLinear):
            wt, wj = lin.dequantize().numpy(), np.asarray(ref.dequantize())
            # a flipped code moves its weight by one step of its group
            step = np.repeat(np.asarray(ref.scales), ref.groupsize, 0)[
                :, :wj.shape[1]]
            if ref.perm is not None:
                step = step[np.argsort(np.asarray(ref.perm))]
            assert (np.abs(wt - wj) <= step * 1.001 + 1e-6).all(), name
            n_codes += wt.size
            n_equal += int((np.abs(wt - wj) <= 1e-5 * step.max()).sum())
            if ref.perm is not None:
                np.testing.assert_array_equal(lin.perm.numpy(),
                                              np.asarray(ref.perm))
        else:
            assert not hasattr(ref, "packed"), name
    assert n_equal >= 0.995 * n_codes, (n_equal, n_codes)
    toks = np.random.default_rng(4).integers(0, 256, (2, 16)).astype(
        np.int32)
    lj = np.asarray(JL.llama_forward(qj, jnp.asarray(toks), cfg_j))
    lt = TL.llama_forward(qt, torch.as_tensor(toks), cfg_t).numpy()
    np.testing.assert_allclose(lt, lj, rtol=0, atol=2e-2)


@pytest.mark.parametrize("layout", ["fused", "separate"])
def test_quantize_llama_gptq_matches_jax(tiny_model, layout):
    """quantize_llama_gptq (4 samples, batches of 2, g32, 4/3-bit
    candidates under a threshold that picks both; the separate layout
    also quantizes the lm_head) against the JAX package's on the same
    carried weights."""
    cfg_j, cfg_t, params, calib = tiny_model
    if layout == "fused":
        params = JL.fuse_llama_params(params)
    tparams = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    kw = dict(candidate_bits=(3, 4), groupsize=32, loss_threshold=1.5e-4,
              batch_size=2, verbose=False,
              quantize_lm_head=layout == "separate")
    qj, bits_j = j_gptq(params, jnp.asarray(calib), cfg_j, **kw)
    qt, bits_t = quantize_llama_gptq(tparams, calib, cfg_t, device="cpu",
                                     **kw)
    assert set(bits_t.values()) == {3, 4}, bits_t
    assert ("lm_head" in bits_t) == (layout == "separate")
    _assert_converted_equal(qt, qj, bits_t, bits_j, cfg_t, cfg_j)


def test_quantize_llama_gptq_batch_remainder(tiny_model):
    """n_samples % batch_size != 0: the JAX package broadcasts one
    positions array of batch_size rows to every batch, so its last,
    shorter batch fails (fault R8); the port gives each batch positions
    of its own shape and matches its own batch_size=1 conversion (the
    same Hessians, summed in another order)."""
    cfg_j, cfg_t, params, calib = tiny_model
    params = dict(params, layers=params["layers"][:1])
    cfg_j1, cfg_t1 = _tiny(n_layers=1)
    calib3 = calib[:3]
    with pytest.raises(TypeError):
        j_gptq(params, jnp.asarray(calib3), cfg_j1, groupsize=32,
               batch_size=2, verbose=False)
    tparams = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    q2, bits2 = quantize_llama_gptq(tparams, calib3, cfg_t1, groupsize=32,
                                    batch_size=2, verbose=False,
                                    device="cpu")
    q1, bits1 = quantize_llama_gptq(tparams, calib3, cfg_t1, groupsize=32,
                                    batch_size=1, verbose=False,
                                    device="cpu")
    assert bits1 == bits2
    for name, lin in q2["layers"][0].items():
        if isinstance(lin, QuantLinear):
            ref = q1["layers"][0][name]
            assert (lin.packed["w"] != ref.packed["w"]).float().mean() \
                <= 0.005, name
            np.testing.assert_allclose(lin.scales.numpy(),
                                       ref.scales.numpy(), rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_act_order_checkpoint_both_ways(tiny_model, tmp_path, writer):
    """An act-order GPTQ checkpoint (perm on every linear) written by one
    package loads in the other: equal perms and packed arrays, and the
    reader's logits equal the writer's within atol 2e-2."""
    cfg_j, cfg_t, params, calib = tiny_model
    params = JL.fuse_llama_params(params)
    kw = dict(groupsize=32, act_order=True, batch_size=2, verbose=False)
    path = str(tmp_path / writer)
    toks = np.random.default_rng(5).integers(0, 256, (2, 16)).astype(
        np.int32)
    if writer == "port":
        tparams = params_from_numpy(jax_tree_to_numpy(params), "cpu")
        qt, bits = quantize_llama_gptq(tparams, calib, cfg_t, device="cpu",
                                       **kw)
        save_quant_checkpoint(path, qt, bits, cfg_t, 32)
        qj, _, bits_j = j_load(path)
        ref = TL.llama_forward(qt, torch.as_tensor(toks), cfg_t).numpy()
        got = np.asarray(JL.llama_forward(qj, jnp.asarray(toks), cfg_j))
        writer_tree, reader_tree = qt, qj
    else:
        qj, bits = j_gptq(params, jnp.asarray(calib), cfg_j, **kw)
        j_save(path, qj, bits, cfg_j, 32)
        qt, _, bits_j = load_quant_checkpoint(path, device="cpu")
        ref = np.asarray(JL.llama_forward(qj, jnp.asarray(toks), cfg_j))
        got = TL.llama_forward(qt, torch.as_tensor(toks), cfg_t).numpy()
        writer_tree, reader_tree = qj, qt
    assert bits_j == bits
    for lw, lr in zip(writer_tree["layers"], reader_tree["layers"]):
        for name in ("wqkv", "wo", "w13", "w2"):
            assert lw[name].perm is not None
            np.testing.assert_array_equal(np.asarray(lr[name].perm),
                                          np.asarray(lw[name].perm))
            np.testing.assert_array_equal(np.asarray(lr[name].packed["w"]),
                                          np.asarray(lw[name].packed["w"]))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
