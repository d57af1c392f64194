"""Sparse (pruning) config tree (port of
``sparsebit_tpu/sparse/sparse_config.py``; reference:
sparsebit/sparse/sparse_config.py:6-17).

The schema and defaults are the JAX package's: SKIP_TRACE_MODULES and
SPARSER.{TYPE, STRATEGY, RATIO, SPECIFIC}, where SPECIFIC holds per-node
fnmatch overrides as the quant config's W/A.SPECIFIC does. A yaml file
is read by the port's config tree, which needs no PyYAML
(``utils/config.load_yaml``).
"""

from sparsebit_tpu_torch.utils.config import CfgNode as CN
from sparsebit_tpu_torch.utils.yaml_utils import _parse_config

_C = CN()
_C.SKIP_TRACE_MODULES = []

_C.SPARSER = CN()
_C.SPARSER.TYPE = "l1norm"
_C.SPARSER.STRATEGY = "unstructure"  # unstructure / structure
_C.SPARSER.RATIO = 0.0
_C.SPARSER.SPECIFIC = []


def parse_sconfig(cfg_file):
    """The default tree merged with ``cfg_file`` (a dict or a yaml path),
    frozen and verified."""
    sconfig = _parse_config(cfg_file, default_cfg=_C)
    assert sconfig.SPARSER.STRATEGY in ("structure", "unstructure"), (
        "unknown sparse strategy: {}".format(sconfig.SPARSER.STRATEGY))
    assert 0.0 <= sconfig.SPARSER.RATIO < 1.0, "RATIO must be in [0, 1)"
    return sconfig
