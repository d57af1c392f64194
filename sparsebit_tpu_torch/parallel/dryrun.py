"""The multichip dry run (port of ``__graft_entry__.dryrun_multichip``):
the north-star topologies on ``n_ranks`` ranks at tiny widths (vocab
512, dim 256, 2 layers, 4 heads, 2 kv heads, FFN 512, f32, INT4-g64; the
reference's are dim 64 and g16, but K1, the serving engine's matmul on
the card, takes groups of a multiple of 64, and a row shard must hold
whole groups), each with a loss assertion:

1. dp x tp x pp (dp = n/4, tp = pp = 2): one Adam step of QLoRA over a
   packed INT4 tensor-parallel backbone through the GPipe waves
   (``pp.pp_tp_qlora_loss``);
2. TP serving on (dp = n/2, tp = 2): one quantized ``tp_decode_step`` over
   the rank's heads of an int8 KV cache, then ``TPDecodeEngine`` admitting
   and decoding two requests;
3. dp x tp (dp = n/2, tp = 2): a float training step of
   ``tp_llama_loss``;
4. dp x sp (dp = 2, sp = n/2): a float training step of
   ``sp_llama_loss``, with the K/V all_gather and with ring attention.

Every rank is a process (``multihost.spawn_ranks``) on the backend
``multihost`` chooses for its device: gloo on the CPU; NCCL on the card,
where rank r takes card r % count (NCCL refuses two ranks on one card).
Every loss must be finite and the same on every rank.

    python -m sparsebit_tpu_torch.parallel.dryrun 4 --device cpu
"""

import argparse
import math

import torch
import torch.distributed as dist

from sparsebit_tpu_torch import resolve_device

CFG_KW = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
              ffn_dim=512, max_seq_len=64, dtype="float32")
GS = 64
TIMEOUT_S = 120  # tiny collectives: a rank that waits longer is hung


def _params(dev):
    from sparsebit_tpu_torch.llm.llama import init_llama_params, llama_tiny

    cfg = llama_tiny(**CFG_KW)
    return cfg, init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


@torch.no_grad()
def _sgd(params, lr=1e-3):
    from sparsebit_tpu_torch.llm.convert import tree_tensors

    for t in tree_tensors(params):
        if t.grad is not None:
            t -= lr * t.grad


def _rank(rank, n, address, device_type):
    from sparsebit_tpu_torch.llm import qlora as Q
    from sparsebit_tpu_torch.llm.convert import trainable
    from sparsebit_tpu_torch.llm.decode import prefill
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
    from sparsebit_tpu_torch.llm.llama import quantize_llama_params
    from sparsebit_tpu_torch.llm.quant import QuantLinear
    from sparsebit_tpu_torch.llm.serving import TPDecodeEngine
    from sparsebit_tpu_torch.parallel import multihost
    from sparsebit_tpu_torch.parallel import pp as PP
    from sparsebit_tpu_torch.parallel import tp as TP
    from sparsebit_tpu_torch.parallel.mesh import (
        make_mesh,
        make_mesh_named,
        sum_grads,
    )
    from sparsebit_tpu_torch.parallel.sp import sp_llama_loss

    dev = (torch.device("cuda", rank % torch.cuda.device_count())
           if device_type == "cuda" else torch.device("cpu"))
    multihost.TIMEOUT_S = TIMEOUT_S
    multihost.initialize_multihost(address, n, rank, device=dev)
    out = {"backend": dist.get_backend(), "device": str(dev), "losses": {}}
    try:
        cfg, params = _params(dev)

        # 1. dp x tp x pp: a QLoRA step over packed tensor-parallel stages
        dp = n // 4
        mesh3 = make_mesh_named(device_type, dp=dp, tp=2, pp=2)
        _, T, r = TP.tp_group(mesh3)
        lparams = Q.wrap_llama_lora(
            params, r=4, generator=torch.Generator(device=dev).manual_seed(7))
        ppp = PP.stack_llama_stages(
            TP.shard_llama_params_tp(lparams, cfg, T, bits=4, groupsize=GS,
                                     rank=r),
            2, rank=mesh3.get_local_rank("pp"))
        lora = PP.pp_extract_lora(ppp)
        opt = torch.optim.Adam(Q.lora_parameters(lora), lr=1e-3)
        tokens3 = torch.zeros((4 * dp, 17), dtype=torch.int32, device=dev)
        loss = PP.pp_tp_qlora_loss(lora, ppp, tokens3, cfg, mesh3, 2)
        loss.backward()
        sum_grads(lora, mesh3, ("dp",))
        opt.step()
        out["losses"]["dp x tp x pp QLoRA"] = loss.item()
        out["dp x tp x pp"] = (dp, 2, 2)

        # 2. quantized TP decode over the rank's heads, then the engine
        mesh = make_mesh(dp=n // 2, tp=2, device_type=device_type)
        _, T, r = TP.tp_group(mesh)
        qtp = TP.shard_llama_params_tp(params, cfg, T, bits=4, groupsize=GS,
                                       rank=r)
        cache = init_kv_cache(cfg, 2, 16, quantized=True, device=dev)
        with torch.no_grad():
            logits, cache = prefill(
                params, torch.zeros((2, 5), dtype=torch.int32, device=dev),
                cache, cfg)
            tok = torch.argmax(logits, -1).to(torch.int32)
            dec, _ = TP.tp_decode_step(qtp, tok, TP.shard_kv_cache_tp(
                cache, r, T), cfg, mesh)
        out["decode_finite"] = bool(torch.isfinite(dec).all())
        qparams = quantize_llama_params(params, lambda p, lin: (
            QuantLinear.from_dense(lin.w.to(torch.float32), bits=4,
                                   groupsize=GS)))
        eng = TPDecodeEngine(qparams, cfg, mesh, max_batch=2, max_len=32,
                             chunk=4, device=dev)
        r1 = eng.add_request([3, 17, 9, 30, 7], max_new_tokens=5)
        r2 = eng.add_request([5, 9], max_new_tokens=4)
        got = eng.run()
        out["engine_tokens"] = (got[r1], got[r2])
        del eng

        # 3. dp x tp float training step
        ptp = trainable(TP.shard_llama_params_tp(params, cfg, T, rank=r))
        tokens = torch.zeros((2 * (n // 2), 16), dtype=torch.int32,
                             device=dev)
        loss = TP.tp_llama_loss(ptp, tokens, cfg, mesh)
        loss.backward()
        sum_grads(ptp, mesh, ("dp",))
        _sgd(ptp)
        out["losses"]["dp x tp"] = loss.item()

        # 4. dp x sp float training steps, K/V all_gather and ring
        mesh_sp = make_mesh_named(device_type, dp=2, sp=n // 2)
        for ring in (False, True):
            p = trainable(_params(dev)[1])
            loss = sp_llama_loss(p, torch.zeros((4, 16), dtype=torch.int32,
                                                device=dev),
                                 cfg, mesh_sp, dp_axis="dp", ring=ring)
            loss.backward()
            sum_grads(p, mesh_sp, ("sp", "dp"))
            _sgd(p)
            out["losses"]["dp x sp ring={}".format(ring)] = loss.item()
    finally:
        dist.destroy_process_group()
    return out


def dryrun_multichip(n_ranks, device=None):
    """Run the four topologies on ``n_ranks`` spawned ranks (a multiple of
    4) on ``device`` (the card unless the caller names another): raises
    unless every loss is finite and equal on every rank, every decode
    logit finite and the engine's requests decode their tokens on every
    rank alike. Returns the ranks' records."""
    from sparsebit_tpu_torch.parallel.multihost import free_port, spawn_ranks

    if n_ranks % 4:
        raise ValueError("dryrun_multichip needs n_ranks % 4 == 0 (dp x tp "
                         "x pp with tp = pp = 2), got {}".format(n_ranks))
    dev = resolve_device(device)
    res = spawn_ranks(_rank, n_ranks, args=(
        n_ranks, "localhost:{}".format(free_port()), dev.type))
    first = res[0]
    for name, loss in first["losses"].items():
        losses = [r["losses"][name] for r in res]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError("non-finite {} loss: {}".format(name, losses))
        if any(v != loss for v in losses):
            raise AssertionError("{}: the ranks' losses differ: {}".format(
                name, losses))
        print("dryrun_multichip {} OK: {} ranks, {}, loss={}".format(
            name, n_ranks, first["backend"], loss))
    if not all(r["decode_finite"] for r in res):
        raise AssertionError("non-finite TP decode logits")
    a, b = first["engine_tokens"]
    if (len(a), len(b)) != (5, 4) or any(
            r["engine_tokens"] != first["engine_tokens"] for r in res):
        raise AssertionError("TP engine tokens: {}".format(
            [r["engine_tokens"] for r in res]))
    print("dryrun_multichip TP decode and serving engine OK: tp=2, tokens "
          "r1={} r2={}".format(a, b))
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    from sparsebit_tpu_torch.parallel.dryrun import dryrun_multichip as run

    run(args.n_ranks, args.device)
