"""Sparser registry (port of ``sparsebit_tpu/sparse/sparsers``; reference:
sparsebit/sparse/sparsers/__init__.py)."""

SPARSER_REGISTRY = {}


def register_sparser(cls):
    SPARSER_REGISTRY[cls.TYPE.lower()] = cls
    return cls


from sparsebit_tpu_torch.sparse.sparsers.base import Sparser  # noqa: E402,F401
from sparsebit_tpu_torch.sparse.sparsers import (  # noqa: E402,F401
    l1norm,
    l2norm,
    random as _random,
    slimming,
)


def build_sparser(config):
    stype = config.SPARSER.TYPE.lower()
    assert stype in SPARSER_REGISTRY, "no sparser named {} (have: {})".format(
        stype, sorted(SPARSER_REGISTRY))
    return SPARSER_REGISTRY[stype](config)
