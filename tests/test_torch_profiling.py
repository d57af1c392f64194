"""The port's profiling helpers (``utils/profiling.py``) on the CPU, beside
the JAX package's (``sparsebit_tpu/utils/profiling.py``):

- ``wall_timer`` fills ``box["seconds"]`` and prints the JAX helper's
  ``[label] x.xxx ms`` line; ``sync`` takes a tensor, a callable or a
  sequence, each waited for (on the CPU there is nothing to wait for);
- ``trace`` profiles a gpt2_tiny forward with ``torch.profiler`` and
  writes a Chrome trace into the directory given: the file is JSON whose
  events name the forward's ops (``aten::linear`` among them), and the
  profile's ``key_averages()`` count them. On the card the same trace
  holds the CUDA kernels (chip_smoke.py's trace check).
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import torch

from sparsebit_tpu.utils import profiling as J
from sparsebit_tpu_torch.models import create_model
from sparsebit_tpu_torch.utils import profiling as T

LINE = re.compile(r"^\[(\w+)\] \d+\.\d{3} ms$")


def test_wall_timer_matches_jax_line(capsys):
    x = torch.ones(64, 64)
    for sync in (None, x, lambda: x @ x, [x, x]):
        with T.wall_timer("torch", sync=sync) as box:
            x @ x
        assert box["seconds"] > 0.0
    with J.wall_timer("jax", sync=jnp.ones(4)) as jbox:
        jnp.ones(4) * 2
    assert jbox["seconds"] > 0.0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5
    assert [LINE.match(ln).group(1) for ln in lines] == ["torch"] * 4 + [
        "jax"]


def test_trace_writes_a_chrome_trace(tmp_path):
    model = create_model("gpt2_tiny", device="cpu").eval()
    ids = torch.from_numpy(np.arange(16, dtype=np.int32)[None])
    logdir = str(tmp_path / "trace")
    with torch.no_grad(), T.trace(logdir) as prof:
        model(ids)
    assert prof.trace_path == os.path.join(logdir, "trace.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::linear" in names
    counts = {a.key: a.count for a in prof.key_averages()}
    assert counts["aten::linear"] == 2 * 4 + 1  # 4 a block, and lm_head
