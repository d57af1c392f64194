"""The port's true-width 2/3-bit serving against the JAX package, on the
CPU: the plane-concat containers (pack_planes_serving, with_plane_serving,
prepare_params_host), the round-to-nearest quantizer (from_dense), the
routing of a stacked "pl" linear, and K4's plane mode.

K4's plane mode runs its plain version here (ops/layer_fused
._fused_layers_plain with wbits 2/3), which the CUDA kernel matches bit
for bit on the card; the JAX side runs its plane megakernel in interpret
mode, as tests/test_layer_fused.py does. Weights are quantized by the JAX
package from numpy draws and carried across as arrays, so both sides
read the same codes. The configuration is tests/test_torch_layer_fused.py's
(dim 512, 4 heads of 128, ffn 384, groupsize 64, two layers), where every
plane-mode width is padded (pallas_n_pad) past its logical one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import decode as JD
from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu.ops import layer_fused as JLF
from sparsebit_tpu.ops import packing as JP
from sparsebit_tpu.ops.quant_matmul import quant_matmul_a8_stacked as j_a8st
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.quant import QuantLinear
from sparsebit_tpu_torch.ops import layer_fused as TLF
from sparsebit_tpu_torch.ops import packing as TP
from sparsebit_tpu_torch.ops import quant_matmul as TQM

from test_torch_engine import jax_tree_to_numpy
from test_torch_layer_fused import CFG_KW, GS, LX, _cache, _rope

torch.set_num_threads(1)

# K4's plain version against the JAX megakernel: the tolerance
# tests/test_torch_layer_fused.py holds the nibble mode to (f32 sums in
# another order); planes against nibble in the port: the reference's own
# (tests/test_layer_fused.py:574-577)
RTOL, ATOL = 2e-2, 9e-2
TIGHT = 2e-4
NAMES = ("wqkv", "wo", "w13", "w2")
SHAPES = {"wqkv": (512, 1536), "wo": (512, 512), "w13": (512, 768),
          "w2": (384, 512)}


def _torch(a):
    """A JAX or numpy array as a torch tensor (bf16 kept as bf16)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _same(t, j):
    """A port tensor equals a JAX array bit for bit (bf16 compared as
    f32, which holds it exactly)."""
    j = jnp.asarray(j)
    if j.dtype == jnp.bfloat16:
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _same_linear(t, j):
    assert (t.bits, t.groupsize, t.out_features, t.impl) == (
        j.bits, j.groupsize, j.out_features, j.impl)
    assert set(t.packed) == set(j.packed)
    for k in j.packed:
        _same(t.packed[k], j.packed[k])
    _same(t.scales, j.scales)
    _same(t.zeros, j.zeros)


@pytest.mark.parametrize("bits", [2, 3])
def test_pack_planes_serving_matches_jax(bits):
    """The plane concat is bit-identical to the JAX package's, and both
    unpack routes (unpack_planes_serving, unpack_columns' "pl" branch)
    give the codes back."""
    codes = np.random.default_rng(bits).integers(
        0, 2 ** bits, (64, 2048)).astype(np.uint8)
    pl = TP.pack_planes_serving(torch.from_numpy(codes), bits)
    jpl = JP.pack_planes_serving(jnp.asarray(codes), bits)
    assert pl.shape[-1] == 2048 * bits // 8
    _same(pl, jpl)
    np.testing.assert_array_equal(
        TP.unpack_planes_serving(pl, bits, 2048).numpy(), codes)
    np.testing.assert_array_equal(
        TP.unpack_columns({"pl": pl}, bits, 2048).numpy(), codes)


@pytest.mark.parametrize("bits", [2, 3])
@pytest.mark.parametrize("drop_fold", [True, False])
def test_with_plane_serving_matches_jax(bits, drop_fold):
    """with_plane_serving: the same containers as the JAX package's (the
    2-bit "w" is the "pl" tensor itself), in_features from the "pl" rows,
    and dequantize unchanged."""
    rng = np.random.default_rng(10 + bits)
    K, N = 256, 700  # N pads to the 3-bit (1024) or 2-bit (1024) multiple
    codes = rng.integers(0, 2 ** bits, (K, N)).astype(np.uint8)
    s = rng.uniform(0.001, 0.01, (K // GS, N)).astype(np.float32)
    z = rng.integers(0, 2 ** bits, (K // GS, N)).astype(np.float32)
    jl = JQuant.from_codes(jnp.asarray(codes), jnp.asarray(s),
                           jnp.asarray(z), bits, GS)
    tl = QuantLinear.from_codes(torch.from_numpy(codes), torch.from_numpy(s),
                                torch.from_numpy(z), bits, GS)
    jp, tp = (jl.with_plane_serving(drop_fold=drop_fold),
              tl.with_plane_serving(drop_fold=drop_fold))
    _same_linear(tp, jp)
    assert tp.in_features == K
    if bits == 2 and drop_fold:
        assert tp.packed["w"] is tp.packed["pl"]
    np.testing.assert_array_equal(tp.dequantize().numpy(),
                                  np.asarray(jp.dequantize()))
    assert tp.with_plane_serving() is tp


@pytest.mark.parametrize("bits,gs,sym,mse", [
    (2, 64, False, False), (3, 64, False, False), (4, 128, False, True),
    (8, -1, True, False), (3, -1, False, True)])
def test_from_dense_matches_jax(bits, gs, sym, mse):
    """Round-to-nearest quantization: equal codes, scales and zeros equal
    to f32 rounding (both compute in f32; a division may round apart)."""
    w = (np.random.default_rng(bits).standard_normal((256, 320)) * 0.05
         ).astype(np.float32)
    w[:, 7] = 0.0  # a degenerate all-zero column
    jl = JQuant.from_dense(jnp.asarray(w), bits=bits, groupsize=gs, sym=sym,
                           mse=mse)
    tl = QuantLinear.from_dense(torch.from_numpy(w), bits=bits,
                                groupsize=gs, sym=sym, mse=mse)
    assert (tl.bits, tl.groupsize, tl.out_features) == (bits, gs, 320)
    np.testing.assert_allclose(tl.scales.numpy(), np.asarray(jl.scales),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tl.zeros.numpy(), np.asarray(jl.zeros))
    for k in jl.packed:
        _same(tl.packed[k], jl.packed[k])


def _jax_model(layer_bits, seed=5):
    cfg = JL.llama_tiny(**dict(CFG_KW, max_seq_len=64, n_layers=2))
    params = JL.fuse_llama_params(
        JL.init_llama_params(cfg, jax.random.PRNGKey(seed)))
    return JL.quantize_llama_params(params, lambda p, lin: JQuant.from_dense(
        lin.w.astype(jnp.float32), bits=layer_bits[int(p.split(".")[1])],
        groupsize=GS))


@pytest.mark.parametrize("layer_bits,sub4,head_bits", [
    ((3, 3), "planes", None), ((2, 2), "planes", 8), ((3, 3), "nibble", 8),
    ((4, 3), "nibble", None)])
def test_prepare_params_host_matches_jax(layer_bits, sub4, head_bits):
    """prepare_params_host: per-layer and stacked, every linear in the
    JAX package's container bit for bit (s4r at 4 bits, "pl" or s4
    nibbles at 2/3, bf16 qparams), the head RTN-quantized to W8A8."""
    jq = _jax_model(layer_bits)
    tq = params_from_numpy(jax_tree_to_numpy(jq), "cpu")
    jp = JD.prepare_params_host(jq, sub4=sub4, head_bits=head_bits)
    tp = TD.prepare_params_host(tq, sub4=sub4, head_bits=head_bits)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for n in NAMES:
            _same_linear(tl[n], jl[n])
    if head_bits is None:
        _same(tp["lm_head"].w, jp["lm_head"].w)
    else:
        assert isinstance(tp["lm_head"], QuantLinear)
        _same_linear(tp["lm_head"], jp["lm_head"])
    stacked = TD.stack_layers(tp)
    for n in NAMES:
        for k, v in stacked["layers"][n].packed.items():
            assert v.shape[0] == 2
            _same(v[1], jp["layers"][1][n].packed[k])
    if sub4 == "planes" and layer_bits[0] == 2:
        st = stacked["layers"]["w13"]
        assert st.packed["w"] is st.packed["pl"]


def test_prepare_params_host_planes_refuses_mixed_bits():
    """sub4="planes" needs one bit width (decode.py:702-720), as the JAX
    package's; "nibble" takes the mixed model."""
    jq = _jax_model((4, 3))
    tq = params_from_numpy(jax_tree_to_numpy(jq), "cpu")
    with pytest.raises(ValueError):
        JD.prepare_params_host(jq, sub4="planes")
    with pytest.raises(ValueError, match="uniform bit"):
        TD.prepare_params_host(tq, sub4="planes")
    stacked_form = dict(tq, layers=dict(tq["layers"][0],
                                        wo=tq["layers"][1]["wo"]))
    with pytest.raises(ValueError, match="uniform bit"):
        TD.prepare_params_host(stacked_form, sub4="planes")


@pytest.mark.parametrize("bits,M", [(3, 8), (3, 96), (2, 8)])
def test_stacked_pl_linear_routes_as_the_reference(bits, M, monkeypatch):
    """call_stacked on a "pl" stack: K7-a8 (3 bits) or K6 (2 bits) within
    supports_planes (3 bits need 128-row groups there), the dense product
    past 64 rows; the output equals the JAX package's
    quant_matmul_a8_stacked to f32 summation order."""
    rng = np.random.default_rng(bits * 10 + M)
    K, N, gs = 512, 768, 128
    jls = [JQuant.from_dense(jnp.asarray(rng.standard_normal((K, N)).astype(
        np.float32) * 0.05), bits=bits, groupsize=gs).with_plane_serving()
        for _ in range(2)]
    jst = jax.tree.map(lambda *a: jnp.stack(a), *jls)
    tst = TD.stack_layers({"layers": [
        {"w": params_from_numpy(jax_tree_to_numpy(jl), "cpu")}
        for jl in jls]})["layers"]["w"]
    called = []
    for name in ("quant_matmul_3bit", "quant_matmul_w_a8", "_dense"):
        fn = getattr(TQM, name)
        monkeypatch.setattr(TQM, name, lambda *a, _n=name, _f=fn, **k: (
            called.append(_n), _f(*a, **k))[1])
    x = rng.standard_normal((M, K)).astype(np.float32)
    got = tst.call_stacked(torch.from_numpy(x), 1).numpy()
    want = np.asarray(j_a8st(
        jnp.asarray(x), jst.packed, jst.scales, jst.zeros, 1, bits, gs,
        jst.n_padded))[:, :N]
    kernel = "quant_matmul_3bit" if bits == 3 else "quant_matmul_w_a8"
    assert called == [kernel if M <= 64 else "_dense"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---- K4's plane mode --------------------------------------------------------

def _layer_linears(bits, seed):
    """Per layer, the four fused linears RTN-quantized at ``bits`` by the
    JAX package, with bf16 qparams (as served)."""
    rng = np.random.default_rng(seed)
    return [{n: JQuant.from_dense(jnp.asarray(rng.standard_normal(
        SHAPES[n]).astype(np.float32) * 0.05), bits=bits, groupsize=GS
    ).with_sz_dtype() for n in NAMES} for _ in range(LX)]


def _stacks(layers, serving):
    """(w, s, z) layer stacks of the four linears in ``serving``: "plane"
    ("pl"), "nibble" (2/3-bit codes as s4r) or "s4r" (4-bit)."""
    conv = {"plane": lambda ln: ln.with_plane_serving(),
            "nibble": lambda ln: ln.with_nibble_serving(),
            "s4r": lambda ln: ln.with_s4_rows(drop_fold=True)}[serving]
    key = "pl" if serving == "plane" else "s4r"
    out = []
    for n in NAMES:
        lins = [conv(lyr[n]) for lyr in layers]
        out.append(tuple(jnp.stack(a) for a in (
            [ln.packed[key] for ln in lins], [ln.scales for ln in lins],
            [ln.zeros for ln in lins])))
    return out


def _norms(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((1 + 0.1 * rng.standard_normal((LX, 512))
                              ).astype(np.float32)) for _ in range(2)]


def _port_call(x, pos, ws, norms, cache, wbits, li_cache=0):
    cos, sin = _rope(pos)
    flat = [_torch(t) for w in ws for t in w]
    out, *cache = TLF.fused_decoder_layers(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cos),
        torch.from_numpy(sin), *flat, *norms, *cache,
        TL.llama_tiny(**CFG_KW), GS, wbits=wbits, li_cache=li_cache)
    return out, cache


def _jax_call(x, pos, ws, norms, cache, wbits):
    """The JAX megakernel in interpret mode, caches in its serving layout
    (scales transposed, bf16)."""
    cos, sin = _rope(pos)
    k, v, ks, vs = [jnp.asarray(t.numpy()) for t in cache]
    ks = jnp.swapaxes(ks, 2, 3).astype(jnp.bfloat16)
    vs = jnp.swapaxes(vs, 2, 3).astype(jnp.bfloat16)
    flat = [t for w in ws for t in w]
    out, k, v, ks, vs = jax.jit(lambda: JLF.fused_decoder_layers(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cos), jnp.asarray(sin),
        *flat, jnp.asarray(norms[0].numpy()), jnp.asarray(norms[1].numpy()),
        k, v, ks, vs, JL.llama_tiny(**CFG_KW), GS, interpret=True,
        signed=wbits == 4, wbits=wbits))()
    return np.asarray(out), [
        np.asarray(k), np.asarray(v),
        np.asarray(jnp.swapaxes(ks, 2, 3).astype(jnp.float32)),
        np.asarray(jnp.swapaxes(vs, 2, 3).astype(jnp.float32))]


@pytest.fixture(scope="module")
def plane_runs():
    """For (bits, B): the port's plane and nibble calls and the JAX plane
    call over the same checkpoint, inputs and cache."""
    runs = {}
    for bits, B in ((3, 1), (3, 2), (2, 1)):
        layers = _layer_linears(bits, 20 + bits)
        norms = _norms(3)
        rng = np.random.default_rng(40 + B)
        x = rng.standard_normal((B, 512)).astype(np.float32)
        pos = np.array([5, 130][:B], np.int32)
        cache = _cache(7, B)
        pl, nib = _stacks(layers, "plane"), _stacks(layers, "nibble")
        runs[bits, B] = dict(
            plane=_port_call(x, pos, pl, norms, [t.clone() for t in cache],
                             bits),
            nibble=_port_call(x, pos, nib, norms,
                              [t.clone() for t in cache], 4),
            jax=_jax_call(x, pos, pl, norms, cache, bits),
            pl_width=(pl[0][0].shape[-1], pl[0][1].shape[-1]))
    return runs


@pytest.mark.parametrize("bits,B", [(3, 1), (3, 2), (2, 1)])
def test_plane_mode_matches_jax(plane_runs, bits, B):
    """K4's plane mode (plain version) against the JAX plane megakernel:
    output within the nibble mode's tolerance, KV codes and scales equal;
    the stack is 3N/8 (N/4) bytes wide over a padded N."""
    run = plane_runs[bits, B]
    out, cache = run["plane"]
    jout, jcache = run["jax"]
    np.testing.assert_allclose(out.numpy(), jout, rtol=RTOL, atol=ATOL)
    for t, j in zip(cache, jcache):
        np.testing.assert_array_equal(t.numpy(), j)
    width, n_pad = run["pl_width"]
    assert width * 8 == bits * n_pad and n_pad == (2048 if bits == 3
                                                    else 1536)


@pytest.mark.parametrize("bits,B", [(3, 1), (3, 2), (2, 1)])
def test_plane_mode_matches_nibble_container(plane_runs, bits, B):
    """The same checkpoint served as planes and as s4 nibbles: integer dots
    equal, outputs within 2e-4, KV codes and scales equal
    (tests/test_layer_fused.py:503-577)."""
    run = plane_runs[bits, B]
    (out, cache), (nout, ncache) = run["plane"], run["nibble"]
    np.testing.assert_allclose(out.numpy(), nout.numpy(), rtol=TIGHT,
                               atol=TIGHT)
    for a, b in zip(cache, ncache):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_segmented_mixed_stack_matches_homogeneous():
    """A 4-bit layer then a 3-bit layer as two launches (s4r with
    li_cache 0, then planes with li_cache 1; the f32 rows carry between
    them) against one homogeneous nibble launch over both
    (tests/test_layer_fused.py:580-656): within 2e-4, KV codes equal."""
    four, three = _layer_linears(4, 31), _layer_linears(3, 32)
    norms = _norms(4)
    x = np.random.default_rng(9).standard_normal((2, 512)).astype(
        np.float32)
    pos = np.array([9, 140], np.int32)
    homog = [{n: (four[0][n], three[1][n])[li] for n in NAMES}
             for li in range(LX)]
    ref, rcache = _port_call(x, pos, _stacks(homog, "nibble"), norms,
                             _cache(8, 2), 4)
    cache = _cache(8, 2)
    seg0 = [tuple(t[:1] for t in w) for w in _stacks(four, "s4r")]
    seg1 = [tuple(t[1:] for t in w) for w in _stacks(three, "plane")]
    out, cache = _port_call(x, pos, seg0, [t[:1] for t in norms], cache, 4,
                            li_cache=0)
    out, cache = _port_call(out.numpy(), pos, seg1, [t[1:] for t in norms],
                            cache, 3, li_cache=1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TIGHT,
                               atol=TIGHT)
    for a, b in zip(cache, rcache):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plane_route_predicate():
    """A "pl" stack of one bit width takes K4 over an int8 cache (W2's K is
    its full row count; padded N is fine); mixed widths, a bf16 cache or a
    prompt step do not. The kernel's shape check wants (L, K, 3Ns/8)."""
    cfg = TL.llama_tiny(**CFG_KW)
    tq = params_from_numpy(jax_tree_to_numpy(_jax_model((3, 3))), "cpu")
    layers = TD.stack_layers(TD.prepare_params_host(tq, sub4="planes"))[
        "layers"]
    assert TD._scan_uses_layer_kernel(1, layers, "int8", cfg, 8)
    assert not TD._scan_uses_layer_kernel(1, layers, False, cfg, 8)
    assert not TD._scan_uses_layer_kernel(2, layers, "int8", cfg, 8)
    assert TLF.fused_layer_supported(cfg, GS, 8, f_pad=384, wbits=3)
    assert not TLF.fused_layer_supported(cfg, GS, 8, f_pad=384, wbits=5)
    mixed = dict(layers, wo=layers["wo"]._replace(bits=2))
    assert not TD._scan_uses_layer_kernel(1, mixed, "int8", cfg, 8)
    ws = [(layers[n].packed["pl"], layers[n].scales, layers[n].zeros)
          for n in NAMES]
    K_N = ((512, 1536), (512, 512), (512, 768), (384, 512))
    assert TLF._weight_shapes_ok(ws, K_N, GS, 3)
    assert not TLF._weight_shapes_ok(ws, K_N, GS, 2)
    assert not TLF._weight_shapes_ok(ws, K_N, GS, 4)
