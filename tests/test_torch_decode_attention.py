"""K5, the port's decode attention (its plain version on the CPU), against
the JAX package's decode_attention / decode_attention_stacked in
interpret mode: int8 and bf16 caches, GQA n_rep 1/2/4, ragged lengths.

Tolerance 2e-4, the reference's own oracle (tests/test_attention.py:43):
f32 dots and softmax sums taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.ops.attention import decode_attention as j_attn
from sparsebit_tpu.ops.attention import (
    decode_attention_stacked as j_attn_stacked)
from sparsebit_tpu_torch.ops import attention as TA

torch.set_num_threads(1)

L, B, S, Hkv, D = 2, 4, 64, 4, 128
LENGTH = np.array([0, 13, 40, 63], np.int32)  # rows [0, length] attend


def _bf16_pair(a):
    """One bf16 array for both packages: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)
    return j, t


def _cache(quantized, rng):
    if quantized:
        k = rng.integers(-128, 128, (L, B, S, Hkv, D)).astype(np.int8)
        v = rng.integers(-128, 128, (L, B, S, Hkv, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (L, B, S, Hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (L, B, S, Hkv)).astype(np.float32)
        j = [jnp.asarray(a) for a in (k, v, ks, vs)]
        t = [torch.from_numpy(a) for a in (k, v, ks, vs)]
        return j, t
    (jk, tk), (jv, tv) = (_bf16_pair(rng.standard_normal((L, B, S, Hkv, D)))
                          for _ in range(2))
    return [jk, jv, None, None], [tk, tv, None, None]


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("stacked", [False, True])
def test_decode_attention_matches_jax(quantized, n_rep, stacked):
    rng = np.random.default_rng(n_rep + 10 * quantized)
    H = Hkv * n_rep
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache(quantized, rng)
    jl, tl = jnp.asarray(LENGTH), torch.from_numpy(LENGTH)
    if stacked:
        ref = j_attn_stacked(jnp.asarray(q), jk, jv, jks, jvs, 1, jl, H,
                             interpret=True)
        out = TA.decode_attention_stacked(torch.from_numpy(q), tk, tv, tks,
                                          tvs, 1, tl)
    else:
        sl = (lambda a: None if a is None else a[1])
        ref = j_attn(jnp.asarray(q), jk[1], jv[1], sl(jks), sl(jvs), jl, H,
                     interpret=True)
        out = TA.decode_attention(torch.from_numpy(q), tk[1], tv[1], sl(tks),
                                  sl(tvs), tl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_decode_attention_supported_rule():
    """head_dim a multiple of 128 and an int8 or float cache; no Hkv
    tiling rule (a Mosaic limit, fault R3)."""
    assert TA.decode_attention_supported((1, 32, 128), "int8")
    assert TA.decode_attention_supported((1, 32, 128), False)
    assert not TA.decode_attention_supported((1, 8, 64), "int8")
    assert not TA.decode_attention_supported((1, 32, 128), "int4")
