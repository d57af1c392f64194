"""Graph passes of the graph regime (port of
``sparsebit_tpu/quantization/converters``): the subgraph matcher, the
simplify passes and the fuse passes."""

from sparsebit_tpu_torch.quantization.converters.simplifiers import (  # noqa: F401
    simplify,
)
from sparsebit_tpu_torch.quantization.converters.fuse_operations import (  # noqa: F401
    fuse_operations,
)
from sparsebit_tpu_torch.quantization.converters.matcher import (  # noqa: F401
    MatchingNode,
    ReplacePatternBase,
    SubgraphMatcher,
)
