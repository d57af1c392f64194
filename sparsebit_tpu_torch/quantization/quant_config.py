"""Quantization config tree (port of
``sparsebit_tpu/quantization/quant_config.py``; reference:
sparsebit/quantization/quant_config.py:6-96).

The schema and defaults are the JAX package's, so that one yaml file or
dict means the same thing to both packages: BACKEND "virtual" (fake
quantization) or "onnxruntime" / "tensorrt" / "tpu" (the JAX package's
deploy backends; the port's deploy path comes with ``deploy.py``),
W/A.QUANTIZER.GROUPSIZE for group-wise weights, and A.OBSERVER.LAYOUT
NHWC (default), NCHW or NLC.
"""

from sparsebit_tpu_torch.quantization.common import (
    Backend,
    QScheme,
    get_backend,
    get_qscheme,
)
from sparsebit_tpu_torch.utils.config import CfgNode as CN
from sparsebit_tpu_torch.utils.yaml_utils import _parse_config

_C = CN()
_C.BACKEND = "virtual"
_C.SKIP_TRACE_MODULES = []

_C.SCHEDULE = CN()
_C.SCHEDULE.FUSE_BN = False
_C.SCHEDULE.BN_TUNING = False
_C.SCHEDULE.DISABLE_UNNECESSARY_QUANT = True

_C.W = CN()
_C.W.QSCHEME = None
_C.W.QUANTIZER = CN()
_C.W.QUANTIZER.TYPE = "uniform"
_C.W.QUANTIZER.DISABLE = False
_C.W.QUANTIZER.BIT = -1
_C.W.QUANTIZER.GROUPSIZE = -1
_C.W.OBSERVER = CN()
_C.W.OBSERVER.TYPE = "MINMAX"
_C.W.OBSERVER.PERCENTILE = CN()
_C.W.OBSERVER.PERCENTILE.ALPHA = 0.001
_C.W.OBSERVER.ACIQ = CN()
_C.W.OBSERVER.ACIQ.DISTRIBUTION = "GAUS"
_C.W.SPECIFIC = []

_C.A = CN()
_C.A.QSCHEME = None
_C.A.QUANTIZER = CN()
_C.A.QUANTIZER.TYPE = "uniform"
_C.A.QUANTIZER.DISABLE = False
_C.A.QUANTIZER.BIT = -1
_C.A.QUANTIZER.GROUPSIZE = -1
_C.A.QUANTIZER.PACT = CN()
_C.A.QUANTIZER.PACT.ALPHA_VALUE = 10
_C.A.OBSERVER = CN()
_C.A.OBSERVER.TYPE = "MINMAX"
_C.A.OBSERVER.PERCENTILE = CN()
_C.A.OBSERVER.PERCENTILE.ALPHA = 0.001
_C.A.OBSERVER.MOVING_AVERAGE = CN()
_C.A.OBSERVER.MOVING_AVERAGE.EMA_RATIO = 0.9
_C.A.OBSERVER.ACIQ = CN()
_C.A.OBSERVER.ACIQ.DISTRIBUTION = "GAUS"
_C.A.OBSERVER.LAYOUT = "NHWC"  # NHWC / NCHW / NLC
_C.A.QADD = CN()
_C.A.QADD.ENABLE_QUANT = False
_C.A.SPECIFIC = []


def parse_qconfig(cfg_file):
    """The default tree merged with ``cfg_file`` (a dict or a yaml path),
    frozen and verified."""
    qconfig = _parse_config(cfg_file, default_cfg=_C)
    verify_bits(qconfig)
    verify_backend(qconfig)
    verify_schedule(qconfig)
    return qconfig


def verify_bits(qconfig):
    assert qconfig.W.QUANTIZER.BIT >= 0, (
        "bitwidth of weight should be a non-negative number")
    assert qconfig.A.QUANTIZER.BIT >= 0, (
        "bitwidth of activation should be a non-negative number")


def verify_backend(qconfig):
    backend = get_backend(qconfig.BACKEND)
    w_qscheme = get_qscheme(qconfig.W.QSCHEME)
    a_qscheme = get_qscheme(qconfig.A.QSCHEME)
    if backend in (Backend.ONNXRUNTIME, Backend.TENSORRT):
        assert (qconfig.W.QUANTIZER.BIT == 8
                and qconfig.A.QUANTIZER.BIT == 8), (
            "onnxruntime/tensorrt only support bit=8; use 'virtual' or "
            "'tpu' for <8bit")
    if backend == Backend.TENSORRT:
        assert w_qscheme == QScheme.PER_CHANNEL_SYMMETRIC, (
            "the qscheme of weight should be per-channel-symmetric for "
            "tensorrt")
        assert a_qscheme == QScheme.PER_TENSOR_SYMMETRIC, (
            "the qscheme of activation should be per-tensor-symmetric for "
            "tensorrt")
    if backend == Backend.TPU:
        # the JAX package's int8 deploy path: symmetric weights, so that
        # the int8 GEMM has no zero-point term on the weights
        assert w_qscheme in (QScheme.PER_CHANNEL_SYMMETRIC,
                             QScheme.PER_TENSOR_SYMMETRIC), (
            "tpu backend requires symmetric weight quant")


def verify_schedule(qconfig):
    if qconfig.SCHEDULE.BN_TUNING:
        assert get_qscheme(qconfig.W.QSCHEME) in (
            QScheme.PER_CHANNEL_SYMMETRIC, QScheme.PER_CHANNEL_AFFINE), (
            "the qscheme of weight must be per-channel when bn-tuning "
            "enabled")
    return qconfig
