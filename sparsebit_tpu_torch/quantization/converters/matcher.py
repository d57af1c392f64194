"""Subgraph pattern matcher and replace-pattern base (port of
``sparsebit_tpu/quantization/converters/matcher.py``; reference:
sparsebit/quantization/converters/utils/). A backtracking matcher over
topological order: every shipped pattern is a chain or near-chain, and
patterns with SUBSET input semantics are unsupported, as in the JAX
package."""


class MatchingNode:
    """One node of a pattern.

    inputs: pattern-node names (positional) or None for a wildcard.
    op_types: acceptable op classes (isinstance check on node.op).
    checker: optional fn(graph_node) -> bool.
    """

    def __init__(self, name, inputs, op_types, checker=None):
        self.name = name
        self.inputs = list(inputs)
        self.op_types = tuple(op_types)
        self.checker = checker


class SubgraphMatcher:
    def __init__(self, pattern_nodes, strict_internal=True):
        self.pattern = {n.name: n for n in pattern_nodes}
        used_as_input = {i for n in pattern_nodes for i in n.inputs
                         if i is not None}
        anchors = [n.name for n in pattern_nodes
                   if n.name not in used_as_input]
        assert len(anchors) == 1, (
            "pattern must have exactly one anchor (output)")
        self.anchor = anchors[0]
        self.strict_internal = strict_internal

    def _node_ok(self, pnode, gnode):
        if not isinstance(gnode.op, pnode.op_types):
            return False
        return pnode.checker is None or pnode.checker(gnode)

    def _try_match(self, graph, pname, gnode, assign):
        if pname in assign:
            return assign[pname] is gnode
        pnode = self.pattern[pname]
        if not self._node_ok(pnode, gnode):
            return False
        g_inputs = [a.node if hasattr(a, "node") else None
                    for a in gnode.args]
        if len(pnode.inputs) > len(g_inputs):
            return False
        assign[pname] = gnode
        for i, in_name in enumerate(pnode.inputs):
            if in_name is None:
                continue
            if (g_inputs[i] is None
                    or not self._try_match(graph, in_name, g_inputs[i],
                                           assign)):
                del assign[pname]
                return False
        return True

    def match_all(self, graph):
        """{pattern_name: graph Node} for each match found."""
        matches = []
        for gnode in graph.op_nodes:
            assign = {}
            if self._try_match(graph, self.anchor, gnode, assign):
                if self.strict_internal and not self._internal_ok(graph,
                                                                  assign):
                    continue
                matches.append(dict(assign))
        return matches

    def _internal_ok(self, graph, assign):
        """Non-anchor matched nodes have all their users inside the match
        (so that structural rewrites keep the semantics)."""
        matched = set(id(n) for n in assign.values())
        for pname, gnode in assign.items():
            if pname == self.anchor:
                continue
            for user in graph.successors(gnode):
                if id(user) not in matched:
                    return False
        return True


class ReplacePatternBase:
    """Apply ``replace`` until a fixpoint (reference
    subgraph_matching_replace_pattern.py:72-112, APPLY_REPEAT)."""

    STRICT_INTERNAL = True

    def make_nodes(self):
        raise NotImplementedError

    def replace(self, graph, match):
        """Perform the rewrite; return True if the graph changed."""
        raise NotImplementedError

    def apply(self, graph, max_iters=1000):
        matcher = SubgraphMatcher(self.make_nodes(),
                                  strict_internal=self.STRICT_INTERNAL)
        changed_any = False
        for _ in range(max_iters):
            changed = False
            for match in matcher.match_all(graph):
                if self.replace(graph, match):
                    changed = True
                    break  # graph edited; match again
            if not changed:
                break
            graph.prune()
            changed_any = True
        return changed_any
