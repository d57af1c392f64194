"""Carry a parameter tree across from the JAX package (port side of
``sparsebit_tpu/llm/convert.py``).

The tree is nested dicts and lists of numpy arrays and plain metadata, so
this module needs nothing of JAX:

- a QuantLinear is ``{"packed": {name: uint8 array}, "scales", "zeros",
  "bits", "groupsize", "out_features", "bias", "perm"}``;
- a DenseLinear is ``{"w", "bias"}``;
- any other array is a plain tensor (norms, embeddings).

bf16 arrays travel as their ``uint16`` bit pattern: every uint16 array in
the tree is read back as bf16. The npz checkpoint loader comes later.
"""

import numpy as np
import torch

from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear


def _tensor(a, device):
    if a is None:
        return None
    a = np.require(a, requirements=["C", "W"])  # torch needs writable
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device):
    """Port parameters on ``device`` from a numpy tree (see module doc)."""
    if isinstance(tree, dict) and "packed" in tree:
        return QuantLinear(
            {k: _tensor(v, device) for k, v in tree["packed"].items()},
            _tensor(tree["scales"], device), _tensor(tree["zeros"], device),
            int(tree["bits"]), int(tree["groupsize"]),
            int(tree["out_features"]), _tensor(tree.get("bias"), device),
            _tensor(tree.get("perm"), device),
        )
    if isinstance(tree, dict) and set(tree) <= {"w", "bias"} and "w" in tree:
        return DenseLinear(_tensor(tree["w"], device),
                           _tensor(tree.get("bias"), device))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _tensor(tree, device)
