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


# ---- gradients (QLoRA): the int8 backward and quant_matmul's dx --------------
#
# The JAX side runs under jax.jit, where XLA folds its division by 127 into
# the multiply the port uses (ROADMAP, Numerics), so int8 codes are equal.
# dx tolerance: 1e-5 of max |dx| for the f32 products (the same f32 terms
# summed in another order; the plain K8/K7 route and the dense route of
# the forward agree to 1e-4, the module's oracle); the int8 backward's dx is
# exact integer sums times f32 scales, 1e-6 of max |dx|.

def _int8_weight(seed, K_, N_):
    rng = np.random.default_rng(seed)
    wq = rng.integers(-127, 128, (K_, N_)).astype(np.int8)
    w_scale = rng.uniform(0.001, 0.01, (1, N_)).astype(np.float32)
    return wq, w_scale


def test_requantize_per_input_channel_matches_jax():
    """Codes (clipped to [-128, 127]) and per-K scales equal to the
    jitted reference."""
    import jax

    from sparsebit_tpu.ops.int8_matmul import (
        requantize_per_input_channel as j_req)
    from sparsebit_tpu_torch.ops.int8_matmul import (
        requantize_per_input_channel)

    wq, w_scale = _int8_weight(1, 96, 40)
    jq, js = jax.jit(j_req)(jnp.asarray(wq), jnp.asarray(w_scale))
    tq, ts = requantize_per_input_channel(torch.from_numpy(wq),
                                          torch.from_numpy(w_scale))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == (40, 96)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_dynamic_and_its_dx_match_jax(dtype):
    """int8_matmul_dynamic's output and its dx (the reference's
    custom_vjp: tokenwise-int8(g) @ bwd_wq) against jax.vjp, x of 20 rows
    in f32 or bf16; dx in x's dtype. A bf16 x is quantized in bf16 as the
    reference is written (equal codes); XLA on the CPU keeps that scale in
    f32 (excess precision), the port rounds it to bf16, so the bf16
    output is held to 2^-8 of max |out| (one bf16 rounding)."""
    import jax

    from sparsebit_tpu.ops.int8_matmul import int8_matmul_dynamic as j_imm
    from sparsebit_tpu.ops.int8_matmul import (
        requantize_per_input_channel as j_req)
    from sparsebit_tpu_torch.ops import int8_matmul as TI

    wq, w_scale = _int8_weight(2, 64, 48)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 5, 64)).astype(
        np.float32)).to(dtype)
    g = rng.standard_normal((4, 5, 48)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x.float().numpy(), jdt)
    jw, jws = jnp.asarray(wq), jnp.asarray(w_scale)
    jbw, jbs = j_req(jw, jws)

    def f(a, gg):
        out, vjp = jax.vjp(lambda t: j_imm(t, jw, jws, jbw, jbs), a)
        return out, vjp(gg)[0]

    jout, jdx = jax.jit(f)(jx, jnp.asarray(g))
    bw, bs = TI.requantize_per_input_channel(torch.from_numpy(wq),
                                             torch.from_numpy(w_scale))
    xr = x.clone().requires_grad_()
    out = TI.int8_matmul_dynamic(xr, torch.from_numpy(wq),
                                 torch.from_numpy(w_scale), bw, bs)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and xr.grad.dtype == dtype
    ref = np.asarray(jout)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    assert np.abs(out.detach().numpy() - ref).max() <= tol * np.abs(
        ref).max()
    jd = np.asarray(jdx.astype(jnp.float32))
    assert np.abs(xr.grad.float().numpy() - jd).max() <= tol * np.abs(
        jd).max()


def test_int8_gemm_is_exact_and_refuses_other_types():
    from sparsebit_tpu_torch.ops.int8_matmul import int8_gemm

    rng = np.random.default_rng(4)
    a = rng.integers(-128, 128, (3, 7, 4096)).astype(np.int8)
    b = rng.integers(-128, 128, (4096, 24)).astype(np.int8)
    out = int8_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.int32 and tuple(out.shape) == (3, 7, 24)
    np.testing.assert_array_equal(
        out.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    with pytest.raises(TypeError):
        int8_gemm(torch.from_numpy(a).float(), torch.from_numpy(b))


@pytest.mark.parametrize("M", [1, 16, 17])
@pytest.mark.parametrize("K,N", [(12, 20), (4100, 36), (64, 44)])
def test_int_mm_padding_keeps_the_exact_product(M, K, N):
    """pad_for_int_mm, the card's route of int8_gemm: the padded shapes
    are what torch._int_mm takes (more than 16 rows, K and N multiples of
    8), the padding is zeros, and rows [0, M), columns [0, N) of the
    padded product equal the exact product, at M = 1, 16, 17 and K, N = 4
    (mod 8) among them."""
    from sparsebit_tpu_torch.ops.int8_matmul import pad_for_int_mm

    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    xp, wp = pad_for_int_mm(torch.from_numpy(a), torch.from_numpy(b))
    Mp, Kp = xp.shape
    assert Mp == max(M, 17) and Kp % 8 == 0 and Kp - K < 8
    assert wp.shape[0] == Kp and wp.shape[1] % 8 == 0 and wp.shape[1] - N < 8
    assert xp.dtype == wp.dtype == torch.int8
    assert xp.is_contiguous() and wp.is_contiguous()
    assert not xp[M:].any() and not xp[:, K:].any()
    assert not wp[K:].any() and not wp[:, N:].any()
    full = xp.numpy().astype(np.int64) @ wp.numpy().astype(np.int64)
    np.testing.assert_array_equal(full[:M, :N],
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("bits,gs", [(4, 64), (3, 128), (8, -1)])
def test_prepare_a8_backward_matches_jax(bits, gs):
    """The int8 W^T of prepare_a8_backward (codes clipped to [-127, 127])
    and its per-K scales equal to the jitted reference."""
    import jax

    q, s, z, _ = _operands(bits, gs, 1, 5 + bits)
    jp = j_pack(jnp.asarray(q), bits)
    tp = pack_columns(torch.from_numpy(q), bits)
    jq, js = jax.jit(lambda p, a, b: JQ.prepare_a8_backward(
        p, a, b, bits, N, gs))(jp, jnp.asarray(s), jnp.asarray(z))
    tq, ts = TQ.prepare_a8_backward(tp, torch.from_numpy(s),
                                    torch.from_numpy(z), bits, N, gs)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == (N, K)
    assert int(tq.abs().max()) <= 127
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits,gs", [(4, 128), (3, 128)])
@pytest.mark.parametrize("M", [8, 80])
@pytest.mark.parametrize("a8bwd", [False, True])
def test_quant_matmul_dx_matches_jax(bits, gs, M, a8bwd):
    """dx of quant_matmul (g @ dequant(W)^T in f32) and of
    quant_matmul_a8bwd (tokenwise-int8(g) @ bwd_wq) against jax.vjp of
    the reference ops, at M = 8 (K8/K7's route on the card, their plain
    version here) and M = 80 (the dense route); bf16 x, dx in bf16 (one
    bf16 ulp, 2^-8 of max |dx|)."""
    import jax

    q, s, z, x = _operands(bits, gs, M, 20 + bits + M)
    g = np.random.default_rng(M).standard_normal((M, N)).astype(np.float32)
    jp = j_pack(jnp.asarray(q), bits)
    tp = pack_columns(torch.from_numpy(q), bits)
    js, jz = jnp.asarray(s), jnp.asarray(z)
    ts, tz = torch.from_numpy(s), torch.from_numpy(z)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    if a8bwd:
        jbw, jbs = JQ.prepare_a8_backward(jp, js, jz, bits, N, gs)
        tbw, tbs = TQ.prepare_a8_backward(tp, ts, tz, bits, N, gs)

        def jf(t):
            return JQ.quant_matmul_a8bwd(t, jp, js, jz, jbw, jbs, bits, gs,
                                         N)
    else:
        def jf(t):
            return JQ.quant_matmul(t, jp, js, jz, bits, gs, N)

    def f(a, gg):
        out, vjp = jax.vjp(jf, a)
        return out, vjp(gg)[0]

    jout, jdx = jax.jit(f)(jx, jnp.asarray(g))
    xr = xb.clone().requires_grad_()
    out = (TQ.quant_matmul_a8bwd(xr, tp, ts, tz, tbw, tbs, bits, gs, N)
           if a8bwd else TQ.quant_matmul(xr, tp, ts, tz, bits, gs, N))
    out.backward(torch.from_numpy(g))
    _close(out.detach().numpy(), jout)
    assert xr.grad.dtype == torch.bfloat16
    jd = np.asarray(jdx.astype(jnp.float32))
    assert np.abs(xr.grad.float().numpy() - jd).max() <= 2.0 ** -8 * \
        np.abs(jd).max()


def test_quant_matmul_keeps_no_graph_without_a_gradient():
    """Serving calls (x not requiring a gradient, or under no_grad) take
    the forward alone: no autograd node, as before training existed."""
    q, s, z, x = _operands(4, 128, 4, 9)
    tp = pack_columns(torch.from_numpy(q), 4)
    args = (tp, torch.from_numpy(s), torch.from_numpy(z), 4, 128, N)
    assert TQ.quant_matmul(torch.from_numpy(x), *args).grad_fn is None
    xr = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        assert TQ.quant_matmul(xr, *args).grad_fn is None
    assert TQ.quant_matmul(xr, *args).grad_fn is not None
