"""The port's quantization-error profiler
(``quantization/tools/errors_profiler.py``,
``QuantModel.get_quantization_error``) against the JAX package's, on the
CPU: the residual CNN of tests/test_quant_model.py with its JAX weights
carried across, calibrated at 4 bits, the JAX package's qparams carried
into the port. The async (one node quantized at a time), sync
(quantization propagated), cosine and SNR errors of every node agree
with JAX's, with the caller's quant state (quantizers on) surviving the
profiling, as tests/test_quant_model.py:226-236 holds it. Tolerance:
5e-5 relative (the float activations the errors are taken on differ by
an ulp or so between the packages, convolutions summed in other orders:
the pool node's MSE moves by 1.05e-5 relative), and for the cosine
error, 1 - cos, also 4 ulp of 1.0 absolute (its own f32 rounding near
cos = 1: 2.4e-7 on conv1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.quantization.tools import errors_profiler as JE
from sparsebit_tpu_torch.quantization.tools import errors_profiler as TE
from test_torch_graph import pair, rand
from test_torch_quant_model import both, calibrate, cfg_dict

torch.set_num_threads(1)


def profiled_pair():
    jm, tm, shape = pair("resblock")
    x = rand(shape)
    config = cfg_dict()
    config["W"]["QUANTIZER"]["BIT"] = 4
    config["A"]["QUANTIZER"]["BIT"] = 4
    jq, tq = both(jm, tm, x, config)
    for q in (jq, tq):
        calibrate(q, [x])
        q.set_quant(True, True)  # the profiler must still measure vs float
    for name, op in tq.qmodules():
        jop = jq.get_qmodule(name)
        for k in ("input_quantizer", "weight_quantizer"):
            t, j = getattr(op, k), getattr(jop, k)
            if t is not None:
                t.scale = torch.from_numpy(np.array(j.scale)).reshape(
                    t.scale.shape)
                t.zero_point = torch.from_numpy(np.array(
                    j.zero_point)).reshape(t.zero_point.shape)
    return jq, tq, x


@pytest.mark.parametrize("mode", ["async", "sync", "cosine", "snr"])
def test_errors_match_jax(mode):
    jq, tq, x = profiled_pair()
    kw = {"async": {}, "sync": {"is_async": False},
          "cosine": {}, "snr": {}}[mode]
    jc = {"cosine": JE.cosine_checker, "snr": JE.snr_checker}.get(mode)
    tc = {"cosine": TE.cosine_checker, "snr": TE.snr_checker}.get(mode)
    want = jq.get_quantization_error(jnp.asarray(x), checker=jc, **kw)
    with torch.no_grad():
        out_q = tq(torch.from_numpy(x))
    got = tq.get_quantization_error(torch.from_numpy(x), checker=tc, **kw)
    assert list(got) == list(want) and len(got) >= 4
    atol = 4 * 2.0 ** -23 if mode == "cosine" else 0.0
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, rtol=5e-5, atol=atol,
                                   err_msg=name)
    if mode != "snr":
        assert any(v > 0 for v in got.values())
    # the caller's quant state survives profiling
    with torch.no_grad():
        assert torch.equal(tq(torch.from_numpy(x)), out_q)
        tq.set_quant(False, False)
        assert not torch.equal(tq(torch.from_numpy(x)), out_q)


def test_async_and_sync_differ_after_the_first_node():
    """async measures each node on float inputs, sync on the quantized
    activations that reach it: equal at the first quantized node, apart
    later."""
    _, tq, x = profiled_pair()
    a = tq.get_quantization_error(torch.from_numpy(x))
    s = tq.get_quantization_error(torch.from_numpy(x), is_async=False)
    first = next(iter(a))
    assert a[first] == s[first]
    assert any(a[n] != s[n] for n in a)
