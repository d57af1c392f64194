"""The column-plane matmuls K6, K7, K8 of the port (their plain versions
on the CPU) against the JAX package's Pallas kernels in interpret mode,
and the port's QuantLinear ``impl`` dispatch against the JAX one.

Tolerance: 1e-4 of max |out|, the reference's own kernel oracle
(tests/test_ops.py:81,115,139): f32 group sums taken in another order.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu.ops.int8_matmul import tokenwise_quant as j_tokenwise
from sparsebit_tpu.ops.packing import pack_columns as j_pack
from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.quant import QuantLinear
from sparsebit_tpu_torch.ops import quant_matmul as TQ
from sparsebit_tpu_torch.ops.packing import pack_columns

from test_torch_engine import jax_tree_to_numpy

JQ = importlib.import_module("sparsebit_tpu.ops.quant_matmul")

torch.set_num_threads(1)

K, N = 256, 1024  # N: a 3-bit plane width of 128 columns


def _operands(bits, gs, B, seed):
    rng = np.random.default_rng(seed)
    G = K // gs if gs > 0 else 1
    q = rng.integers(0, 2 ** bits, (K, N)).astype(np.uint8)
    s = rng.uniform(0.01, 0.1, (G, N)).astype(np.float32)
    z = rng.integers(0, 2 ** bits, (G, N)).astype(np.float32)
    x = rng.standard_normal((B, K)).astype(np.float32)
    return q, s, z, x


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(out, np.float32) - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("gs,B,sz_bf16", [
    (128, 1, False), (64, 8, True), (-1, 64, False)])
def test_planes_plain_matches_jax_kernel(bits, a8, gs, B, sz_bf16):
    """K8 (f32 x, "w"), K6 (int8 x, "w") and K7 (3-bit, f32 or int8 x),
    grouped and per-channel, f32 or bf16 qparams, B = 1/8/64."""
    q, s, z, x = _operands(bits, gs, B, bits * 10 + B)
    js, jz = jnp.asarray(s), jnp.asarray(z)
    ts, tz = torch.from_numpy(s), torch.from_numpy(z)
    if sz_bf16:
        js, jz = js.astype(jnp.bfloat16), jz.astype(jnp.bfloat16)
        ts, tz = ts.to(torch.bfloat16), tz.to(torch.bfloat16)
    jp = j_pack(jnp.asarray(q), bits)
    tp = pack_columns(torch.from_numpy(q), bits)
    jx = jnp.asarray(x)
    if a8:
        jx = j_tokenwise(jx)[0]
    tx = torch.from_numpy(np.asarray(jx))
    with pltpu.force_tpu_interpret_mode():
        if bits == 3:
            ref = JQ._quant_matmul_pallas_3bit(jx, jp, js, jz, gs, N, a8=a8)
        elif a8:
            ref = JQ._quant_matmul_pallas_a8(jx, jp["w"], js, jz, bits, gs, N)
        else:
            ref = JQ._quant_matmul_pallas(jx, jp["w"], js, jz, bits, gs, N)
    if bits == 3:
        out = TQ.quant_matmul_3bit(tx, tp, ts, tz, gs, N, a8=a8)
    elif a8:
        out = TQ.quant_matmul_w_a8(tx, tp["w"], ts, tz, bits, gs, N)
    else:
        out = TQ.quant_matmul_w(tx, tp["w"], ts, tz, bits, gs, N)
    assert TQ.supports_planes(bits, K, N, gs, B) == JQ._supports_pallas(
        bits, K, N, gs, B)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_65_rows_take_the_dense_route(bits):
    """Past 64 rows both packages leave the kernels (_supports_pallas)
    for the dense product on the dequantized weight, f32 and a8."""
    q, s, z, x = _operands(bits, 128, 65, bits)
    assert not TQ.supports_planes(bits, K, N, 128, 65)
    jp = j_pack(jnp.asarray(q), bits)
    tp = pack_columns(torch.from_numpy(q), bits)
    args_j = (jp, jnp.asarray(s), jnp.asarray(z), bits, 128, N)
    args_t = (tp, torch.from_numpy(s), torch.from_numpy(z), bits, 128, N)
    _close(TQ.quant_matmul(torch.from_numpy(x), *args_t).numpy(),
           JQ.quant_matmul(jnp.asarray(x), *args_j))
    _close(TQ.quant_matmul_a8(torch.from_numpy(x), *args_t).numpy(),
           JQ.quant_matmul_a8(jnp.asarray(x), *args_j))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_quant_linear_auto_impl_carried_across(bits):
    """Fault A: a JAX QuantLinear(impl="auto") carried across by
    params_from_numpy keeps its impl, so the port computes the f32
    quant_matmul (K8/K7) as JAX does, not the W4A8 product."""
    q, s, z, x = _operands(bits, 128, 3, 40 + bits)
    nout = 1000  # padded to the packed-width multiple, then sliced
    jl = JQuant.from_codes(jnp.asarray(q[:, :nout]), jnp.asarray(s[:, :nout]),
                           jnp.asarray(z[:, :nout]), bits, 128)
    tl = params_from_numpy(jax_tree_to_numpy(jl), "cpu")
    assert tl.impl == "auto"
    ref = jl(jnp.asarray(x))
    out = tl(torch.from_numpy(x))
    assert out.shape == (3, nout)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_with_u4_sends_a8_linears_to_k1(bits):
    """with_u4 / with_u4_rows (quant.py:193-275): a 2/3/4-bit fold linear
    gains the s4r view, through which an a8 linear takes K1 with the same
    integer sums as K6/K7 over its planes; 8-bit linears are unchanged."""
    q, s, z, x = _operands(bits, 128, 8, 60 + bits)
    lin = QuantLinear.from_codes(torch.from_numpy(q), torch.from_numpy(s),
                                 torch.from_numpy(z), bits, 128, impl="a8")
    u4 = lin.with_u4()
    assert lin.with_u4_rows().packed.keys() == u4.packed.keys()
    if bits == 8:
        assert u4 is lin
        return
    assert "s4r" in u4.packed and set(lin.packed) < set(u4.packed)
    xt = torch.from_numpy(x)
    _close(u4(xt).numpy(), lin(xt).numpy())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("gps", [1, 3])
def test_split_k_oracle_matches_jax_kernel(bits, a8, gps):
    """K6/K7/K8's algorithm (_qmm_planes_split_plain: K split at group
    boundaries, f32 x as x . (C - z) per group, partials added in split
    order) against the JAX kernels in interpret mode, 4 groups of 64 rows
    cut into splits of 1 or 3 groups, B = 8."""
    q, s, z, x = _operands(bits, 64, 8, bits * 7 + gps)
    jp = j_pack(jnp.asarray(q), bits)
    tp = pack_columns(torch.from_numpy(q), bits)
    jx = jnp.asarray(x)
    if a8:
        jx = j_tokenwise(jx)[0]
    js, jz = jnp.asarray(s), jnp.asarray(z)
    with pltpu.force_tpu_interpret_mode():
        if bits == 3:
            ref = JQ._quant_matmul_pallas_3bit(jx, jp, js, jz, 64, N, a8=a8)
        elif a8:
            ref = JQ._quant_matmul_pallas_a8(jx, jp["w"], js, jz, bits, 64, N)
        else:
            ref = JQ._quant_matmul_pallas(jx, jp["w"], js, jz, bits, 64, N)
    out = TQ._qmm_planes_split_plain(
        torch.from_numpy(np.asarray(jx)), tp, torch.from_numpy(s),
        torch.from_numpy(z), bits, 64, N, gps)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 8, 37, 64])
@pytest.mark.parametrize("K,N,gs", [(4096, 4096, 128), (4096, 11008, 128),
                                    (11008, 4096, 128), (4096, 32000, -1)])
def test_planes_plan_fills_the_card(bits, M, K, N, gs):
    """The launch plan of K6/K7/K8 at LLaMA-7B shapes on a 132-SM card:
    256 threads of CB byte columns x row groups of MR rows that cover M,
    at most 8 rows a thread, splits of whole groups that cover K, none
    longer than 512 rows, and at least two blocks an SM wherever the
    groups allow it."""
    from sparsebit_tpu_torch.ops.packing import pallas_n_pad

    N = N + pallas_n_pad(N, bits)
    P = 8 if bits == 3 else (1 if bits == 8 else 8 // bits)
    MR, CB, gps, splits = TQ.planes_plan(bits, M, K, N, gs, 132)
    RG = TQ.PLANES_THREADS // CB
    assert CB * RG == TQ.PLANES_THREADS and MR * RG >= M
    assert MR in (1, 2, 4, 8) and 16 <= CB <= 256
    G = K // gs if gs > 0 else 1
    assert (splits - 1) * gps < G <= splits * gps
    assert gps == 1 or gps * gs <= 512
    tiles = -(-(N // P) // CB)
    assert tiles * splits >= 2 * 132 or splits == G
