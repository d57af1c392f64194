"""Reference-counted activation storage for layerwise calibration (port of
``sparsebit_tpu/quantization/tools/graph_wrapper.py``; reference:
sparsebit/quantization/tools/graph_wrapper.py:12-114). A node's outputs
are stored per batch and freed as soon as every consumer has used them,
which bounds calibration memory to the live frontier of the graph."""


class SharedData:
    def __init__(self, graph):
        self.graph = graph
        self._storage = {}  # node name -> list of per-batch tensors
        self._remaining = {n.name: len(graph.successors(n))
                           for n in graph.nodes}

    def set_value(self, name, value):
        self._storage[name] = value

    def get_value(self, name):
        return self._storage[name]

    def has(self, name):
        return name in self._storage

    def finish_node(self, name):
        """One consumption of ``name``; freed when its out-degree is
        used up (graph_wrapper.py:35-43)."""
        if name not in self._remaining:
            return
        self._remaining[name] -= 1
        if self._remaining[name] <= 0:
            self._storage.pop(name, None)

    def consume_inputs(self, node):
        for p in node.input_nodes:
            self.finish_node(p.name)

