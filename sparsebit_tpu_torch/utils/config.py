"""A minimal yacs-style config tree (port of
``sparsebit_tpu/utils/config.py``): attribute access,
``merge_from_other_cfg`` / ``merge_from_dict`` / ``merge_from_list`` /
``merge_from_file``, ``clone``, ``freeze`` and yaml dump.

``yaml`` (PyYAML) is imported only where a yaml text is read or written
(``load_yaml``, ``merge_from_list``'s string values, ``dump``), so that
the tree, and every module built on it, imports where PyYAML is not
installed. Without PyYAML, ``merge_from_list`` resolves a string value
as the subset's scalar, and ``load_yaml`` reads the block-mapping subset
that the example config files use (nested mappings of scalars, and the
``SPECIFIC`` sequences of mappings whose values are flow sequences), and
refuses anything beyond it.
"""

import copy
import re


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
        _merge_a_into_b(CfgNode(load_yaml(filename)), self)

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
    possible (PyYAML's scalar resolution, or the subset's where PyYAML is
    missing)."""
    if not isinstance(value, str):
        return value
    try:
        import yaml
    except ImportError:
        try:
            parsed = _scalar(value, 0) if value else value
        except ValueError:
            return value
    else:
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


def load_yaml(filename):
    """The mapping in a yaml file: PyYAML's ``safe_load`` where PyYAML is
    installed, else ``block_mappings``."""
    with open(filename, "r") as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return block_mappings(text)
    return yaml.safe_load(text) or {}


_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_.\-]*):(?:[ ]+(.*))?")
_BOOL = {v: b for b in (True, False) for w in (
    ("yes", "true", "on") if b else ("no", "false", "off"))
    for v in (w, w.capitalize(), w.upper())}
_NULL = ("~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")


def _strip_comment(line):
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(s, no):
    """A plain or quoted scalar as PyYAML resolves it (decimal ints,
    floats with a point, booleans, nulls, strings); ValueError for what
    the subset leaves out."""
    def refuse(why):
        raise ValueError("line {}: {} ({!r})".format(no, why, s))

    if s[0] in "'\"":
        if len(s) < 2 or s[-1] != s[0]:
            refuse("unterminated quote")
        inner = s[1:-1]
        if s[0] == "'":
            return inner.replace("''", "'")
        if "\\" in inner or '"' in inner:
            refuse("escapes in a double-quoted scalar")
        return inner
    if s[0] in "[{&*!|>%@`" or s == "-" or s.startswith("- "):
        refuse("flow collections, lists, anchors, tags and block scalars "
               "need PyYAML")
    if s in _BOOL:
        return _BOOL[s]
    if s in _NULL:
        return None
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if re.match(r"[-+.]?[0-9]", s) or ": " in s or s.endswith(":"):
        refuse("a number or mapping form outside the subset")
    return s


_QKEY = re.compile(r"""(?:"([^"\\]*)"|'((?:[^']|'')*)')[ ]*:(?:[ ]+(.*))?""")


def _flow_sequence(s, no):
    """``[a, "b", 'c']``: a flow sequence of plain or quoted scalars."""
    if not (s.startswith("[") and s.endswith("]")):
        return _scalar(s, no)
    items, cur, quote = [], "", None
    for c in s[1:-1]:
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == ",":
            items.append(cur.strip())
            cur = ""
            continue
        cur += c
    if cur.strip() or items:
        items.append(cur.strip())
    if any(not item for item in items):
        raise ValueError("line {}: an empty flow sequence entry needs "
                         "PyYAML ({!r})".format(no, s))
    return [_scalar(item, no) for item in items]


def _key_value(body, quoted_keys):
    m = _KEY.fullmatch(body)
    if m:
        return m.group(1), m.group(2)
    m = _QKEY.fullmatch(body) if quoted_keys else None
    if m:
        key = m.group(1) if m.group(1) is not None else m.group(2).replace(
            "''", "'")
        return key, m.group(3)
    return None


def _flow_mappings(lines, no):
    """The lines after ``key: [{`` (line ``no``) up to a ``}]`` line: a
    flow sequence of flow mappings written one ``key: value`` entry a line,
    entries separated by commas, mappings by a ``}, {`` line, each value a
    scalar or a flow sequence of scalars."""
    out, cur, comma = [], {}, True
    for at, raw in lines:
        body = _strip_comment(raw).strip()
        if not body:
            continue
        if body in ("}]", "}, {", "},{"):
            out.append(cur)
            if body == "}]":
                return out
            cur, comma = {}, True
            continue
        if not comma:
            raise ValueError("line {}: flow mapping entries need a comma "
                             "between them ({!r})".format(at, raw))
        comma = body.endswith(",")
        kv = _key_value(body[:-1].rstrip() if comma else body, True)
        value = kv[1].strip() if kv is not None and kv[1] else ""
        if not value or (value[0] not in "[\"'" and any(
                c in value for c in ",[]{}")):
            raise ValueError("line {}: not a key: value entry of a flow "
                             "mapping ({!r})".format(at, raw))
        cur[kv[0]] = _flow_sequence(value, at)
    raise ValueError("line {}: flow sequence not closed by a }}] line"
                     .format(no))


def block_mappings(text):
    """Nested block mappings of scalars (``key: value`` lines, indented
    by spaces, ``#`` comments), and, as a mapping's value, a sequence of
    mappings whose values are scalars or flow sequences of scalars (the
    ``SPECIFIC`` form of the qconfig files), either as a block sequence
    (``- `` items) or as a flow sequence of flow mappings opened by
    ``key: [{`` at the end of a line, one entry a line, and closed by a
    ``}]`` line: the data ``yaml.safe_load`` gives for such a text.
    ValueError for anything else (other lists, flow collections
    elsewhere or on one line, anchors, multi-line scalars, tabs)."""
    root = {}
    # the open collections: (indent, container, is a sequence item's
    # mapping); a sequence is (indent, list, None)
    stack = [(0, root, False)]
    pending = None  # (indent, mapping, key) of a key with no value yet
    lines = enumerate(text.splitlines(), 1)
    for no, raw in lines:
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body[0] == "\t" or line.startswith("---"):
            raise ValueError("line {}: tabs and documents need PyYAML "
                             "({!r})".format(no, raw))
        item = body == "-" or body.startswith("- ")
        if pending is not None:
            p_indent, mapping, key = pending
            pending = None
            if indent > p_indent and item:
                mapping[key] = []
                stack.append((indent, mapping[key], None))
            elif indent > p_indent:
                mapping[key] = {}
                stack.append((indent, mapping[key], False))
            else:
                mapping[key] = None
        while indent < stack[-1][0]:
            stack.pop()
        top_indent, container, in_item = stack[-1]
        if isinstance(container, list):
            if not item or indent != top_indent:
                raise ValueError("line {}: not an item of the enclosing "
                                 "block sequence ({!r})".format(no, raw))
            body = body[2:].lstrip(" ")
            indent += len(line) - indent - len(body)
            container.append({})
            stack.append((indent, container[-1], True))
            top_indent, container, in_item = stack[-1]
        kv = _key_value(body, in_item) if indent == top_indent else None
        if kv is None:
            raise ValueError("line {}: not a key of the enclosing block "
                             "mapping ({!r})".format(no, raw))
        key, value = kv
        if value is None or not value.strip():
            if in_item:
                raise ValueError("line {}: a collection inside a sequence "
                                 "item needs PyYAML ({!r})".format(no, raw))
            pending = (indent, container, key)
        elif in_item:
            container[key] = _flow_sequence(value.strip(), no)
        elif value.strip() == "[{":
            container[key] = _flow_mappings(lines, no)
        else:
            container[key] = _scalar(value.strip(), no)
    if pending is not None:
        pending[1][pending[2]] = None
    return root
