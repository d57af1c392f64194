"""The training cases of tests/test_torch_parallel.py's spawned group (one
rank's part, called by torch_tp_worker.run on the same four gloo ranks):
tp_llama_loss's gradients on Mesh(dp=2, tp=2), sp_llama_loss at sp=4
and dp=2 x sp=2 with and without the ring, pp_llama_loss at (dp, pp, M)
= (1, 4, 4), (2, 2, 2), (1, 2, 4) and over a 4-bit backbone, pipelined
QLoRA (loss, gradients, an Adam step), dp=1 x tp=2 x pp=2 QLoRA, and
BatchNorm's statistics and LSQ's count over a dp group. Returns numpy
losses and each rank's gradients by leaf name."""

import torch

from sparsebit_tpu_torch.llm import qlora as Q
from sparsebit_tpu_torch.llm.convert import (
    params_from_numpy,
    trainable,
    tree_tensors,
)
from sparsebit_tpu_torch.llm.llama import LlamaConfig
from sparsebit_tpu_torch.parallel import pp as PP
from sparsebit_tpu_torch.parallel import tp as TP
from sparsebit_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_named,
    sum_grads,
)
from sparsebit_tpu_torch.parallel.sp import sp_llama_loss


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def dp_batchnorm_case(mesh, shape=(8, 6, 6, 16)):
    """A BatchNorm2d in training mode over the dp group
    (nn.data_parallel) on the rank's rows of a seeded global
    batch, against the same module on the whole batch: the rank's output
    rows, the running statistics, gamma's and beta's gradients (summed
    over dp) and the input gradient rows, each as the largest relative
    error; and LSQ's gradient-scale count of a feature and of a weight
    under the group."""
    import copy

    from sparsebit_tpu_torch.nn import BatchNorm2d, data_parallel
    from sparsebit_tpu_torch.quantization.common import QuantTarget
    from sparsebit_tpu_torch.quantization.quantizers import build_quantizer
    from sparsebit_tpu_torch.utils.config import CfgNode

    g = torch.Generator().manual_seed(21)
    x = torch.randn(shape, generator=g) * 3 + 1
    cot = torch.randn(shape, generator=g)
    bn = BatchNorm2d(shape[-1], device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.rand(shape[-1], generator=g) + 0.5)
        bn.bias.copy_(torch.randn(shape[-1], generator=g))
    ref = copy.deepcopy(bn)
    xr = x.clone().requires_grad_(True)
    ref_out = ref.execute(xr, training=True)
    (ref_out * cot).sum().backward()
    per = shape[0] // mesh["dp"].size()
    rows = slice(mesh.get_local_rank("dp") * per,
                 (mesh.get_local_rank("dp") + 1) * per)
    xl = x[rows].clone().requires_grad_(True)

    def lsq(target):
        return build_quantizer(CfgNode({
            "TARGET": [getattr(QuantTarget, target)],
            "QSCHEME": "per-tensor-symmetric",
            "QUANTIZER": {"TYPE": "lsq", "BIT": 4, "GROUPSIZE": -1},
            "OBSERVER": {"TYPE": "minmax", "LAYOUT": "NHWC"}}))

    qf, qw = lsq("FEATURE"), lsq("WEIGHT")
    with data_parallel(mesh.get_group("dp"), bn, qf, qw):
        out = bn.execute(xl, training=True)
        (out * cot[rows]).sum().backward()
        counts = (qf._grad_elements(xl), qw._grad_elements(xl))
    assert bn.dp_group is None and qf.dp_group is None
    sum_grads([bn.weight, bn.bias], mesh, ("dp",))
    return {"out": _rel(out.detach(), ref_out.detach()[rows]),
            "running_mean": _rel(bn.running_mean, ref.running_mean),
            "running_var": _rel(bn.running_var, ref.running_var),
            "weight_grad": _rel(bn.weight.grad, ref.weight.grad),
            "bias_grad": _rel(bn.bias.grad, ref.bias.grad),
            "x_grad": _rel(xl.grad, xr.grad[rows]),
            "lsq_counts": counts, "local_elements": xl.numel()}


def _grad(t):
    if isinstance(t, TP.TPLinear):
        t = t.local()
    if hasattr(t, "w"):
        t = t.w
    return t.grad.numpy().copy()


def _llama_grads(params):
    """{leaf name: gradient} of a (TP-sharded) LLaMA params tree."""
    out = {"tok_embed": _grad(params["tok_embed"]),
           "norm": _grad(params["norm"]),
           "lm_head": _grad(params["lm_head"])}
    for i, layer in enumerate(params["layers"]):
        for name, leaf in layer.items():
            out["layers.{}.{}".format(i, name)] = _grad(leaf)
    return out


def _stage_grads(params_pp, sid):
    """{leaf name: gradient} of a rank's pipeline stage and the replicated
    leaves, layers by their global index."""
    out = {"tok_embed": _grad(params_pp["embed"]),
           "norm": _grad(params_pp["norm"]),
           "lm_head": _grad(params_pp["head"])}
    layers = params_pp["stages"][sid]
    for i, layer in enumerate(layers):
        for name, leaf in layer.items():
            out["layers.{}.{}".format(sid * len(layers) + i, name)] = \
                _grad(leaf)
    return out


def _lora_grads(lora):
    return {k: (v["lora_A"].grad.numpy().copy(),
                v["lora_B"].grad.numpy().copy()) for k, v in lora.items()}


def _pp_mesh(dp, pp, world):
    # a (dp, pp) mesh smaller than the world repeats over a replica axis
    rep = world // (dp * pp)
    if rep == 1:
        return make_mesh_named("cpu", dp=dp, pp=pp)
    return make_mesh_named("cpu", rep=rep, dp=dp, pp=pp)


def run_training(data, world):
    out = {}
    cfg2 = LlamaConfig(**data["cfg2"])
    cfg4 = LlamaConfig(**data["cfg4"])
    tok2 = torch.from_numpy(data["tokens2"])
    tok4 = torch.from_numpy(data["tokens4"])

    # tensor parallel: dp=2 x tp=2
    mesh = make_mesh(dp=2, tp=2, device_type="cpu")
    _, T, r = TP.tp_group(mesh)
    ptp = trainable(TP.shard_llama_params_tp(
        params_from_numpy(data["dense2"], "cpu"), cfg2, T, rank=r))
    loss = TP.tp_llama_loss(ptp, tok2, cfg2, mesh)
    loss.backward()
    sum_grads(ptp, mesh, ("dp",))
    out["tp_train"] = (loss.item(), _llama_grads(ptp), r)

    # sequence parallel: sp=4 and dp=2 x sp=2, all_gather and ring
    for name, axes in (("sp4", {"sp": 4}), ("dp2_sp2", {"dp": 2, "sp": 2})):
        m = make_mesh_named("cpu", **axes)
        for ring in (False, True):
            p = trainable(params_from_numpy(data["dense2"], "cpu"))
            loss = sp_llama_loss(p, tok2, cfg2, m,
                                 dp_axis="dp" if "dp" in axes else None,
                                 ring=ring)
            loss.backward()
            sum_grads(p, m, tuple(axes))
            out["sp", name, ring] = (loss.item(), _llama_grads(p))

    # pipeline parallel over densified float weights
    for dp, pp, M in data["pp_cases"]:
        m = _pp_mesh(dp, pp, world)
        sid = m.get_local_rank("pp")
        p = trainable(PP.stack_llama_stages(PP.densify_llama_params(
            params_from_numpy(data["dense4"], "cpu")), pp, rank=sid))
        loss = PP.pp_llama_loss(p, tok4, cfg4, m, M)
        loss.backward()
        PP.pp_sum_grads(p, m)
        out["pp", dp, pp, M] = (loss.item(), _stage_grads(p, sid))

    # the 4-bit g32 backbone, pipelined QLoRA and its Adam step
    m = make_mesh_named("cpu", dp=2, pp=2)
    sid = m.get_local_rank("pp")
    with torch.no_grad():
        q = PP.stack_llama_stages(params_from_numpy(data["quant4"], "cpu"),
                                  2, rank=sid)
        out["pp_quant"] = PP.pp_llama_loss(q, tok4, cfg4, m, 2).item()
    qp = PP.stack_llama_stages(params_from_numpy(data["qlora4"], "cpu"), 2,
                               rank=sid)
    backbone = [t.clone() for t in tree_tensors(qp)
                if not any(t is a for v in PP.pp_extract_lora(qp).values()
                           for a in v.values())]
    lora = PP.pp_extract_lora(qp)
    opt = torch.optim.Adam(Q.lora_parameters(lora), lr=1e-2)
    lora, loss1 = PP.pp_qlora_train_step(lora, opt, qp, tok4, cfg4, m, 2)
    grads = _lora_grads(lora)
    with torch.no_grad():
        loss2 = PP.pp_qlora_loss(lora, qp, tok4, cfg4, m, 2).item()
        merged = PP.pp_llama_loss(PP.pp_merge_lora(qp, lora), tok4, cfg4, m,
                                  2).item()
    after = [t for t in tree_tensors(qp)
             if not any(t is a for v in lora.values() for a in v.values())]
    out["pp_qlora"] = {
        "loss": loss1.item(), "grads": grads, "loss_after": loss2,
        "merged": merged, "sid": sid,
        "backbone_equal": len(after) == len(backbone) and all(
            torch.equal(a, b) for a, b in zip(after, backbone))}

    # dp=1 x tp=2 x pp=2 QLoRA over packed tensor-parallel stages
    m = make_mesh_named("cpu", dp=1, tp=2, pp=2)
    _, T, r = TP.tp_group(m)
    sid = m.get_local_rank("pp")
    ppp = PP.stack_llama_stages(TP.shard_llama_params_tp(
        params_from_numpy(data["lora4"], "cpu"), cfg4, T, bits=4,
        groupsize=32, rank=r), 2, rank=sid)
    lora = PP.pp_extract_lora(ppp)
    Q.lora_parameters(lora)
    loss = PP.pp_tp_qlora_loss(lora, ppp, tok4, cfg4, m, 2)
    loss.backward()
    sum_grads(lora, m, ("dp",))
    out["pp_tp"] = (loss.item(), _lora_grads(lora), sid, r)

    # data parallelism's BatchNorm and LSQ count: dp=2 (x 2 replicas)
    out["dp_batchnorm"] = dp_batchnorm_case(
        make_mesh_named("cpu", rep=2, dp=2))
    return out
