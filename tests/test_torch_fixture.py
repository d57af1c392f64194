"""The port's accuracy fixture (``sparsebit_tpu_torch/llm/fixture.py``)
against the JAX package's, on the CPU.

- the Markov corpus: equal bit for bit;
- one ``train_tiny_llama`` Adam step from weights carried across from the
  JAX package, against one optax.adam step on the same windows: the loss
  within rtol 1e-5; every weight whose JAX gradient exceeds 1e-6 within
  1e-6, the rest within lr = 3e-3 (a first Adam step moves a weight by
  lr g / (|g| + 1e-8), so where |g| is near 1e-8 the rounding of an f32
  gradient summed in another order moves the step by a fraction of lr);
- perplexity of JAX-initialised weights carried across (drawn at scale
  0.15, so that quantization moves the perplexity), float / RTN int4 /
  GPTQ int4: rtol 1e-4 / 1e-4 / 2e-3 (GPTQ adds the solver's rounding);
- the port's own ``run_fixture(steps=200)`` under tests/test_fixture.py's
  three claims.

The two packages draw the fixture's weights and windows from different
generators, so their trained models differ; the claims are relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparsebit_tpu.llm import fixture as JF
from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.convert import quantize_llama_gptq as j_gptq
from sparsebit_tpu.llm.eval import perplexity as j_perplexity
from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu_torch.llm import fixture as TF
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import (
    params_from_numpy,
    quantize_llama_gptq,
)
from sparsebit_tpu_torch.llm.eval import perplexity
from sparsebit_tpu_torch.llm.quant import QuantLinear

from test_torch_engine import jax_tree_to_numpy

torch.set_num_threads(1)

SEQLEN = 64


@pytest.mark.parametrize("n,vocab,seed", [(5000, 256, 0), (3000, 97, 5)])
def test_markov_corpus_bit_equal(n, vocab, seed):
    got = TF.make_markov_corpus(n, vocab, seed=seed)
    ref = JF.make_markov_corpus(n, vocab, seed=seed)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert TF.fixture_config() == TL.LlamaConfig(
        **{k: getattr(JF.fixture_config(), k)
           for k in TL.LlamaConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def corpus():
    c = JF.make_markov_corpus(12_000, 256, seed=0)
    return c[:-4096], c[-4096:]


def test_train_step_matches_optax(corpus):
    """train_tiny_llama(steps=1) from carried JAX-initialised weights
    against optax.adam(3e-3) on the windows the port drew."""
    train, _ = corpus
    cfg_j, cfg_t = JF.fixture_config(), TF.fixture_config()
    params = JL.init_llama_params(cfg_j, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    n_windows = len(train) // (SEQLEN + 1)
    idx = torch.randint(0, n_windows, (8,),
                        generator=torch.Generator().manual_seed(1)).numpy()
    toks = train[: n_windows * (SEQLEN + 1)].reshape(
        n_windows, SEQLEN + 1)[idx]
    loss_t = TL.llama_loss(tparams, torch.as_tensor(toks), cfg_t).item()
    got = TF.train_tiny_llama(cfg_t, train, steps=1, params=tparams,
                              device="cpu")

    opt = optax.adam(3e-3)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JL.llama_loss(p, jnp.asarray(toks), cfg_j)))(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    ref = optax.apply_updates(params, updates)
    np.testing.assert_allclose(loss_t, float(loss), rtol=1e-5)
    got_leaves = [t.numpy() for t in TF._leaves(got)]
    ref_leaves = [np.asarray(t) for t in TF._leaves(ref)]
    assert len(got_leaves) == len(ref_leaves) == 2 + 2 * 2 + 1 + 7 * 2
    for g, r, r0, gr in zip(got_leaves, ref_leaves, TF._leaves(params),
                            TF._leaves(grads)):
        assert not np.array_equal(r, np.asarray(r0))  # every leaf moved
        steep = np.abs(np.asarray(gr)) > 1e-6
        np.testing.assert_allclose(g[steep], r[steep], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g, r, rtol=0, atol=3e-3)


def test_fixture_perplexities_match_jax(corpus):
    """Float, RTN int4-g32 and GPTQ int4-g32 (48 calibration windows of
    the fixture's corpus) perplexity over 1024 held-out tokens, both
    packages on the same carried weights."""
    train, held = corpus
    cfg_j, cfg_t = JF.fixture_config(), TF.fixture_config()
    params = JL.init_llama_params(cfg_j, jax.random.PRNGKey(1), scale=0.15)
    tparams = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    ev = held[:1024]
    calib = train[: 48 * (SEQLEN + 1)].reshape(48, SEQLEN + 1)[:, :SEQLEN]
    rtn_j = JL.quantize_llama_params(params, lambda p, lin: JQuant.from_dense(
        lin.w.astype(jnp.float32), bits=4, groupsize=32))
    rtn_t = TL.quantize_llama_params(tparams, lambda p, lin:
                                     QuantLinear.from_dense(lin.w, bits=4,
                                                            groupsize=32))
    gptq_j, _ = j_gptq(params, jnp.asarray(calib), cfg_j,
                       candidate_bits=(4,), groupsize=32, verbose=False)
    gptq_t, _ = quantize_llama_gptq(tparams, calib, cfg_t,
                                    candidate_bits=(4,), groupsize=32,
                                    verbose=False, device="cpu")
    ppl = []
    for (pj, pt), rtol in (((params, tparams), 1e-4),
                           ((rtn_j, rtn_t), 1e-4),
                           ((gptq_j, gptq_t), 2e-3)):
        ref = j_perplexity(pj, ev, cfg_j, seqlen=SEQLEN)
        got = perplexity(pt, ev, cfg_t, seqlen=SEQLEN, device="cpu")
        np.testing.assert_allclose(got, ref, rtol=rtol)
        ppl.append(ref)
    # quantization moved the perplexity well past the tolerances
    assert abs(ppl[1] / ppl[0] - 1) > 1e-3, ppl
    assert abs(ppl[2] / ppl[0] - 1) > 1e-2, ppl


@pytest.fixture(scope="module")
def port_fixture():
    return TF.run_fixture(steps=200, gptq_bits=(4,), device="cpu")


def test_port_fixture_claims(port_fixture):
    """tests/test_fixture.py's three claims on the port's own run: the
    model learned, int4 GPTQ costs < 5 % ppl, GPTQ <= RTN x 1.002."""
    r = port_fixture
    assert set(r) == {"config", "corpus", "train_steps", "groupsize",
                      "seqlen", "ppl_float", "ppl_rtn_int4",
                      "ppl_gptq_int4"}
    assert r["ppl_float"] < 4.0
    assert r["ppl_gptq_int4"] < r["ppl_float"] * 1.05, r
    assert r["ppl_gptq_int4"] <= r["ppl_rtn_int4"] * 1.002, r
