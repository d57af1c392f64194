"""Weight-streaming decode (``llm/offload.py``) on the CPU, as
tests/test_offload.py holds the JAX package's: streamed prefill and
decode_step equal the resident ones within rtol/atol 1e-4 (the reference
single_device_mode's oracle), over a float and an int8 cache; the port's
streamed logits against the JAX package's StreamingLlama on the same
weights within the same tolerance (an f32 model: the two differ only in
the order of f32 sums); an int4 cache refused as the reference refuses
it; ``offload_llama_params`` and ``convert.map_params`` keep the tree.
With ``device="cpu"`` nothing is pinned and no copy stream is made; the
card's path (pinned memory, copy stream, events) runs in chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.kv_cache import init_kv_cache as j_init
from sparsebit_tpu.llm.offload import StreamingLlama as JStreaming
from sparsebit_tpu.llm.offload import offload_llama_params as j_offload
from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import map_params, params_from_numpy
from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
from sparsebit_tpu_torch.llm.offload import (
    StreamingLlama,
    offload_llama_params,
)
from sparsebit_tpu_torch.llm.quant import QuantLinear

from test_torch_engine import jax_tree_to_numpy

torch.set_num_threads(1)

KW = dict(dim=128, ffn_dim=256, n_layers=3, vocab_size=128, max_seq_len=64,
          dtype="float32")
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg_j = JL.llama_tiny(**KW)
    params = JL.init_llama_params(cfg_j, jax.random.PRNGKey(0))
    cfg_t = TL.llama_tiny(**KW)
    tparams = params_from_numpy(jax_tree_to_numpy(params), "cpu")
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 6), 0,
                                           KW["vocab_size"]), np.int32)
    return cfg_j, params, cfg_t, tparams, tokens


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_streaming_matches_resident_and_jax(models, kv_quantized):
    cfg_j, params, cfg_t, tparams, tokens = models
    tok = torch.from_numpy(tokens).long()
    cache = init_kv_cache(cfg_t, 2, 32, kv_quantized, device="cpu")
    ref_logits, cache = TD.prefill(tparams, tok, cache, cfg_t)
    nxt = ref_logits.argmax(-1).to(torch.int32)
    ref_step, _ = TD.decode_step(tparams, nxt, cache, cfg_t)

    sl = StreamingLlama(offload_llama_params(tparams, device="cpu"), cfg_t,
                        prefetch=2, device="cpu")
    assert sl.copy_stream is None
    cache2 = init_kv_cache(cfg_t, 2, 32, kv_quantized, device="cpu")
    logits, cache2 = sl.prefill(tok, cache2)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(), rtol=TOL,
                               atol=TOL)
    step, cache2 = sl.decode_step(nxt, cache2)
    np.testing.assert_allclose(step.numpy(), ref_step.numpy(), rtol=TOL,
                               atol=TOL)
    assert cache2.length.tolist() == [7, 7]

    js = JStreaming(j_offload(params), cfg_j, prefetch=2)
    jc = j_init(cfg_j, 2, 32, quantized=kv_quantized)
    jl, jc = js.prefill(jnp.asarray(tokens), jc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    jstep, _ = js.decode_step(jnp.asarray(nxt.numpy()), jc)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("prefetch", [1, 5])
def test_streaming_quantized_model_any_prefetch(models, prefetch):
    """INT4-g32 linears (K8's plain version), prefetch 1 and past the
    depth: the same logits as the resident decode_step."""
    cfg_j, params, cfg_t, _, tokens = models
    q = JL.quantize_llama_params(params, lambda p, lin: JQuant.from_dense(
        lin.w.astype(jnp.float32), bits=4, groupsize=32))
    tq = params_from_numpy(jax_tree_to_numpy(q), "cpu")
    tok = torch.from_numpy(tokens).long()
    cache = init_kv_cache(cfg_t, 2, 16, device="cpu")
    ref, cache = TD.prefill(tq, tok, cache, cfg_t)
    sl = StreamingLlama(offload_llama_params(tq, device="cpu"), cfg_t,
                        prefetch=prefetch, device="cpu")
    cache2 = init_kv_cache(cfg_t, 2, 16, device="cpu")
    got, cache2 = sl.prefill(tok, cache2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
    assert isinstance(sl.layers_host[0]["wq"], QuantLinear)


def test_streaming_refuses_an_int4_cache(models):
    cfg_j, params, cfg_t, tparams, tokens = models
    sl = StreamingLlama(offload_llama_params(tparams, device="cpu"), cfg_t,
                        device="cpu")
    cache = init_kv_cache(cfg_t, 2, 16, "int4", device="cpu")
    with pytest.raises(ValueError, match="int4"):
        sl.prefill(torch.from_numpy(tokens).long(), cache)
    with pytest.raises(AssertionError):
        JStreaming(j_offload(params), cfg_j).prefill(
            jnp.asarray(tokens), j_init(cfg_j, 2, 16, quantized="int4"))


def test_offload_and_map_params_keep_the_tree(models):
    _, _, cfg_t, tparams, _ = models
    w = torch.randn(128, 256, generator=torch.Generator().manual_seed(0))
    lin = QuantLinear.from_dense(w, bits=2, groupsize=32).with_plane_serving(
        drop_fold=True)
    assert lin.packed["w"] is lin.packed["pl"]
    tree = {"layers": [{"wq": lin, "norm": torch.ones(4)}], "lm_head": 1}
    seen = []
    out = map_params(lambda t: seen.append(t) or t.clone(), tree)
    assert out["layers"][0]["wq"].packed["w"] is \
        out["layers"][0]["wq"].packed["pl"]
    assert len(seen) == 4 and out["lm_head"] == 1  # w/pl once, s, z, norm
    host = offload_llama_params(tparams, device="cpu")
    assert host["tok_embed"] is tparams["tok_embed"]
    for a, b in zip(host["layers"], tparams["layers"]):
        assert set(a) == set(b)
        assert torch.equal(a["wq"].w, b["wq"].w)
        assert not a["wq"].w.is_pinned()


def test_map_params_keeps_no_reference_to_its_results():
    """A streamed layer's device copies must be freed as soon as the
    layer is dropped: map_params leaves no reference cycle holding its
    results (one kept every fetched layer alive until the cyclic garbage
    collector ran: 23 layers at a time on the card)."""
    import gc
    import weakref

    w = torch.ones(8, 4)
    lin = QuantLinear.from_dense(w, bits=4, groupsize=8)
    tree = {"wq": lin, "norm": torch.ones(4)}
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = map_params(lambda t: t.clone(), tree)
        refs = [weakref.ref(out["wq"].scales), weakref.ref(out["norm"])]
        del out
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()
