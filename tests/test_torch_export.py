"""The port's export (``export/torch_export.py``) on the CPU: a
``torch.export`` program in place of the JAX package's StableHLO one,
with the same sidecar.

- ``QuantModel.export`` writes ``model.pt2``, ``quant_meta.json`` and
  ``quant_params.npz``; the metadata equal to the JAX package's for the
  same carried model and calibration data, the npz holding the same
  array names with values within 1e-6 relative (per-channel weight
  scales in the port's layout, out channels first);
- the program loaded back (``torch.export.load``) gives the QuantModel's
  output bit for bit, for a CNN and for an attention block;
- ``DeployedModel.export`` likewise for the integer graph.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sparsebit_tpu import QuantModel as JQuantModel
from sparsebit_tpu import parse_qconfig as j_parse
from sparsebit_tpu_torch import QuantModel as TQuantModel
from sparsebit_tpu_torch import parse_qconfig as t_parse
from sparsebit_tpu_torch.quantization.deploy import deploy
from test_torch_deploy import JNet, TNet, cfg
from test_torch_graph import carry, rand

torch.set_num_threads(1)


def _calibrate(q, x):
    q.prepare_calibration()
    q(x)
    q.calc_qparams()


def _loaded(path):
    return torch.export.load(str(path / "model.pt2")).module()


def test_export_sidecar_matches_jax(tmp_path):
    x = rand((2, 16, 16, 3))
    jm = JNet(jax.random.PRNGKey(1)).eval()
    tm = carry(jm, TNet().eval())
    jq = JQuantModel(jm, j_parse(cfg()), (jnp.asarray(x),))
    tq = TQuantModel(tm, t_parse(cfg()), (torch.from_numpy(x),))
    _calibrate(jq, jnp.asarray(x))
    _calibrate(tq, torch.from_numpy(x))
    jq.export(str(tmp_path / "jax"), jnp.asarray(x))
    tq.export(str(tmp_path / "port"), torch.from_numpy(x))
    names = ["model.pt2", "quant_meta.json", "quant_params.npz"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    meta = [json.loads((tmp_path / d / "quant_meta.json").read_text())
            for d in ("jax", "port")]
    assert meta[1] == meta[0] and len(meta[1]["nodes"]) == 4
    jz = np.load(tmp_path / "jax" / "quant_params.npz")
    tz = np.load(tmp_path / "port" / "quant_params.npz")
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        np.testing.assert_allclose(tz[k].reshape(-1), jz[k].reshape(-1),
                                   rtol=1e-6, err_msg=k)
    with torch.no_grad():
        want = tq(torch.from_numpy(x))
        assert torch.equal(_loaded(tmp_path / "port")(torch.from_numpy(x)),
                           want)


def test_exported_attention_block_and_deployed_model(tmp_path):
    from sparsebit_tpu_torch.models.vit import Attention

    x = torch.from_numpy(rand((2, 16, 64), seed=3))
    attn = Attention(64, num_heads=4,
                     generator=torch.Generator().manual_seed(4)).eval()
    q = TQuantModel(attn, t_parse(cfg(layout="NLC")), (x,))
    _calibrate(q, x)
    q.export(str(tmp_path / "q"), x)
    with torch.no_grad():
        assert torch.equal(_loaded(tmp_path / "q")(x), q(x))
    dm = deploy(q)
    dm.export(str(tmp_path / "d"), x)
    assert [p.name for p in (tmp_path / "d").iterdir()] == ["model.pt2"]
    with torch.no_grad():
        assert torch.equal(_loaded(tmp_path / "d")(x), dm(x))
    # the integer graph exported: int8 weights in the program's state
    program = torch.export.load(str(tmp_path / "d" / "model.pt2"))
    assert any(t.dtype == torch.int8 for t in program.state_dict.values())
