"""``QuantLinear.with_k_pad`` and K4 over a K-padded W2, against the JAX
package and against the unpadded model, on the CPU.

- the padded containers (fold planes at 2/3/4 bits, the s4r rows) with
  their scales (pad groups 1) and zeros (0) equal the JAX package's, and
  the refusals are the reference's (act-order perm, 8 bits, a pad of part
  of a group);
- a padded linear's ``__call__`` (impl "auto" and "a8") and
  ``call_stacked`` against the unpadded one within 1e-6: the pad groups
  add exact zeros, but the per-matmul kernels' K-split plans (K1's, K6-
  K8's) are functions of K, so the padded product's partial sums fall at
  other groups;
- K4's plain version over a W2 padded from F = 384 to 512 rows (s4r, and
  the 3-bit plane concat): output and cache bit for bit the unpadded
  model's, since K4 reads each layer's first F rows and keeps the
  unpadded K split; and within the nibble mode's tolerance of the JAX
  megakernel over the same padded stack (interpret mode), which reads the
  pad rows, as tests/test_layer_fused.py runs it with k_pad;
- a ``DecodeEngine`` over a model whose every W2 is padded (with_k_pad
  1024 would be 7B's, here 768 over F = 512) stays on K4 and gives the
  unpadded engine's tokens and decode logits bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import kv_cache as TK
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.serving import DecodeEngine
from sparsebit_tpu_torch.ops import layer_fused as TLF

from test_torch_engine import (  # noqa: F401  (model: a fixture)
    _requests,
    jax_tree_to_numpy,
    model,
)
from test_torch_layer_fused import CFG_KW, GS, _cache
from test_torch_planes import (
    ATOL,
    RTOL,
    _jax_call,
    _layer_linears,
    _norms,
    _port_call,
    _same_linear,
    _stacks,
)

torch.set_num_threads(1)

F, F_PAD = 384, 512


def _w2(bits, seed=0):
    w = np.random.default_rng(seed).standard_normal((F, 512)).astype(
        np.float32) * 0.05
    jl = JQuant.from_dense(jnp.asarray(w), bits=bits, groupsize=GS
                           ).with_sz_dtype()
    return jl, params_from_numpy(jax_tree_to_numpy(jl), "cpu")


@pytest.mark.parametrize("bits,container", [(4, "fold"), (4, "s4r"),
                                            (3, "fold"), (2, "fold")])
def test_with_k_pad_matches_jax(bits, container):
    jl, tl = _w2(bits)
    if container == "s4r":
        jl, tl = jl.with_s4_rows(drop_fold=True), tl.with_s4_rows(
            drop_fold=True)
    jp, tp = jl.with_k_pad(F_PAD), tl.with_k_pad(F_PAD)
    _same_linear(tp, jp)
    assert tp.k_padded == F_PAD and tp.perm is None
    s = tp.scales.float()
    assert bool((s[F // GS:] == 1).all()) and not tp.zeros[F // GS:].any()
    assert tl.with_k_pad(128) is tl  # 384 is a multiple already


def test_with_k_pad_refusals_match_jax():
    jl, tl = _w2(4)
    jperm = JQuant(jl.packed, jl.scales, jl.zeros, 4, GS, 512,
                   perm=jnp.arange(F))
    tperm = tl._replace(perm=torch.arange(F))
    for jbad, tbad in ((lambda: jl.with_k_pad(416),
                        lambda: tl.with_k_pad(416)),
                       (lambda: jperm.with_k_pad(512),
                        lambda: tperm.with_k_pad(512))):
        with pytest.raises(AssertionError):
            jbad()
        with pytest.raises(ValueError):
            tbad()
    _, t8 = _w2(8)
    with pytest.raises(ValueError):
        t8.with_k_pad(512)


@pytest.mark.parametrize("bits", [4, 3])
def test_padded_linear_matches_unpadded(bits):
    jl, tl = _w2(bits)
    tp = tl.with_k_pad(F_PAD)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, F)).astype(np.float32))
    want = jl.with_k_pad(F_PAD)(jnp.asarray(x.numpy()))
    for impl in ("auto", "a8"):
        a = tl._replace(impl=impl)(x)
        b = tp._replace(impl=impl)(x)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tp(x).numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    sa = TD.stack_layers({"layers": [{"w2": tl}, {"w2": tl}]})
    sp = TD.stack_layers({"layers": [{"w2": tp}, {"w2": tp}]})
    a = sa["layers"]["w2"].call_stacked(x, 1)
    b = sp["layers"]["w2"].call_stacked(x, 1)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)


def test_fused_layer_supported_takes_whole_group_pads():
    cfg = TL.llama_tiny(**CFG_KW)
    for f_pad, ok in ((None, True), (F, True), (F_PAD, True), (448, True),
                      (416, False), (320, False)):
        assert TLF.fused_layer_supported(cfg, GS, 8, f_pad=f_pad) == ok
        assert TLF.fused_layer_supported(cfg, GS, 8, f_pad=f_pad,
                                         wbits=3) == ok


@pytest.mark.parametrize("bits", [4, 3])
def test_k4_padded_w2_matches_unpadded_and_jax(bits):
    layers = _layer_linears(bits, 30 + bits)
    padded = [dict(lyr, w2=lyr["w2"].with_k_pad(F_PAD)) for lyr in layers]
    serving = "s4r" if bits == 4 else "plane"
    ws, wp = _stacks(layers, serving), _stacks(padded, serving)
    assert wp[3][1].shape[1] * GS == F_PAD
    norms = _norms(4)
    rng = np.random.default_rng(50 + bits)
    x = rng.standard_normal((2, 512)).astype(np.float32)
    pos = np.array([7, 131], np.int32)
    cache = _cache(8, 2)
    out, c = _port_call(x, pos, ws, norms, [t.clone() for t in cache], bits)
    outp, cp = _port_call(x, pos, wp, norms, [t.clone() for t in cache],
                          bits)
    assert torch.equal(out, outp)
    for a, b in zip(c, cp):
        assert torch.equal(a, b)
    if bits == 4:
        jout, jcache = _jax_call(x, pos, wp, norms, cache, bits)
        np.testing.assert_allclose(outp.numpy(), jout, rtol=RTOL, atol=ATOL)
        for t, j in zip(cp, jcache):
            np.testing.assert_array_equal(t.numpy(), j)


def test_engine_on_a_padded_model_stays_on_k4_with_equal_tokens(model):
    _, _, cfg_t, tparams = model
    padded = TL.quantize_llama_params(
        tparams, lambda p, lin: lin.with_k_pad(768) if p.endswith("w2")
        else lin, skip=())
    assert padded["layers"][0]["w2"].k_padded == 768
    kw = dict(max_batch=3, max_len=128, chunk=4, device="cpu")
    outs, logits = [], []
    for params in (tparams, padded):
        eng = DecodeEngine(params, cfg_t, **kw)
        assert eng._stacked_chunks
        for r in _requests():
            eng.add_request(r, max_new_tokens=5)
        outs.append(eng.run())
        st = TD.stack_layers(TD.prepare_params_host(params))
        cache = TK.init_kv_cache(cfg_t, 2, 64, device="cpu")
        prompt = torch.from_numpy(
            np.stack([r[:5] for r in _requests()[:2]])).long()
        _, cache = TD.prefill_scanned(st, prompt, cache, cfg_t)
        step, _ = TD.decode_step_scanned(st, prompt[:, -1].int(), cache,
                                         cfg_t)
        logits.append(step)
    assert outs[0] == outs[1]
    assert torch.equal(logits[0], logits[1])
