"""A minimal yacs-style config tree (port of
``sparsebit_tpu/utils/config.py``): attribute access,
``merge_from_other_cfg`` / ``merge_from_dict`` / ``merge_from_list`` /
``merge_from_file``, ``clone``, ``freeze`` and yaml dump.

``yaml`` (PyYAML) is imported only where a yaml text is read or written
(``merge_from_file``, ``merge_from_list``'s string values, ``dump``), so
that the tree, and every module built on it, imports where PyYAML is not
installed.
"""

import copy


class CfgNode(dict):
    """dict with attribute access and recursive merge, yacs-compatible
    subset."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in (init_dict or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError("Non-existent config key: {}".format(name))

    def __setattr__(self, name, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                "Attempted to set {} to {}, but CfgNode is immutable".format(
                    name, value))
        self[name] = value

    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self):
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value):
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def clone(self):
        return copy.deepcopy(self)

    def merge_from_other_cfg(self, other):
        _merge_a_into_b(other, self)

    def merge_from_dict(self, d):
        _merge_a_into_b(CfgNode(d), self)

    def merge_from_file(self, filename):
        import yaml

        with open(filename, "r") as f:
            loaded = yaml.safe_load(f) or {}
        _merge_a_into_b(CfgNode(loaded), self)

    def merge_from_list(self, cfg_list):
        assert len(cfg_list) % 2 == 0, "override list must have even length"
        for key, value in zip(cfg_list[0::2], cfg_list[1::2]):
            parts = key.split(".")
            node = self
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            leaf = parts[-1]
            node[leaf] = _decode_value(value, node.get(leaf, None))

    def to_dict(self):
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v)
                for k, v in self.items()}

    def dump(self):
        import yaml

        return yaml.safe_dump(self.to_dict())

    def __deepcopy__(self, memo):
        new = CfgNode()
        memo[id(self)] = new
        for k, v in self.items():
            new[k] = copy.deepcopy(v, memo)
        return new

    def __repr__(self):
        return "CfgNode({})".format(dict.__repr__(self))


def _decode_value(value, old=None):
    """Coerce a string override to the type of the existing value if
    possible."""
    if not isinstance(value, str):
        return value
    import yaml

    try:
        parsed = yaml.safe_load(value)
    except yaml.YAMLError:
        return value
    if isinstance(old, str) and not isinstance(parsed, str):
        return value
    return parsed


def _merge_a_into_b(a, b):
    for k, v in a.items():
        if isinstance(v, CfgNode) and isinstance(b.get(k, None), CfgNode):
            _merge_a_into_b(v, b[k])
        else:
            b[k] = copy.deepcopy(v)
