"""Graph simplify passes (port of
``sparsebit_tpu/quantization/converters/simplifiers.py``; reference:
sparsebit/quantization/converters/simplifiers/). The reference's
getattr_to_shape has its counterpart in the tracer, which folds shape
reads into constants; split returns its elements directly. So
remove_identity and dead-node pruning remain."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.quantization.converters.matcher import (
    MatchingNode,
    ReplacePatternBase,
)


class RemoveIdentity(ReplacePatternBase):
    """Drop nn.Identity nodes (simplifiers/remove_identity.py)."""

    STRICT_INTERNAL = False

    def make_nodes(self):
        return [MatchingNode(
            "identity", inputs=[None], op_types=[nn.Identity],
            checker=lambda n: getattr(n.op, "remove", True))]

    def replace(self, graph, match):
        node = match["identity"]
        graph.replace_all_uses(node, node.args[0])
        return True


def simplify(graph):
    for pattern in [RemoveIdentity()]:
        pattern.apply(graph)
    graph.prune()
    return graph
