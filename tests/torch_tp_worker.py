"""One rank of tests/test_torch_parallel.py's process group: runs the
port's tensor-parallel functions on the CPU over gloo, then the training
cases of torch_train_worker.py, and returns numpy results. Imports torch
and the port only (spawned ranks import it afresh, so it stays light).
The group's collective timeout is 120 s, so that a hang fails its test
instead of holding the test run."""

import os

import torch
import torch.distributed as dist

from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.kv_cache import KVCache, init_kv_cache
from sparsebit_tpu_torch.llm.llama import LlamaConfig
from sparsebit_tpu_torch.llm.serving import TPDecodeEngine, _serving_layout
from sparsebit_tpu_torch.parallel.mesh import (
    dp_shard_batch,
    make_mesh,
    replicate,
)
from sparsebit_tpu_torch.parallel import multihost
from sparsebit_tpu_torch.parallel.multihost import (
    initialize_multihost,
    local_batch_slice,
)
from sparsebit_tpu_torch.parallel.tp import (
    shard_kv_cache_tp,
    shard_llama_params_tp,
    shard_llama_params_tp_packed,
    tp_decode_chunk,
    tp_decode_step,
    tp_group,
    tp_llama_forward,
    tp_llama_loss,
    tp_prefill_at,
)
from torch_train_worker import run_training


def _cache(c):
    """A KVCache from the numpy dict the test made of a JAX cache."""
    t = {k: None if v is None else torch.from_numpy(v) for k, v in c.items()
         if k != "quantized"}
    return KVCache(t["k"], t["v"], t["k_scale"], t["v_scale"], t["length"],
                   c["quantized"])


def run(rank, world, port, data):
    """``data``: numpy inputs (see the test's ``port_ranks`` fixture).
    Joins through torchrun's variables, builds Mesh(dp=2, tp=2) and runs
    every case on its tp group."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    multihost.TIMEOUT_S = 120
    out = {"joined": initialize_multihost(device="cpu")}
    mesh = make_mesh(dp=2, tp=2, device_type="cpu")
    out["batch_slice"] = local_batch_slice(8, mesh)
    out["dp_rows"] = dp_shard_batch(mesh, torch.arange(8)).tolist()
    tree = {"a": torch.full((3,), float(rank)), "b": [torch.arange(2) + rank]}
    replicate(mesh, tree)
    out["replicated"] = (tree["a"].tolist(), tree["b"][0].tolist())
    cfg = LlamaConfig(**data["cfg"])
    _, T, r = tp_group(mesh)
    out["tp_rank"] = r

    dense = params_from_numpy(data["dense"], "cpu")
    ptp = shard_llama_params_tp(dense, cfg, T, rank=r)
    tokens = torch.from_numpy(data["tokens"])
    out["forward"] = tp_llama_forward(ptp, tokens, cfg, mesh).numpy()
    out["loss"] = float(tp_llama_loss(ptp, tokens, cfg, mesh))

    for mode, case in data["decode"].items():
        cache = shard_kv_cache_tp(_cache(case["cache"]), r, T)
        steps = []
        for tok in (case["tok"], case["tok2"]):
            logits, cache = tp_decode_step(ptp, torch.from_numpy(tok), cache,
                                           cfg, mesh)
            steps.append(logits.numpy())
        out["decode_" + mode] = (steps, cache.length.numpy())

    q = params_from_numpy(data["quant"], "cpu")
    qtp = shard_llama_params_tp_packed(q, cfg, T, conv=_serving_layout,
                                       rank=r)
    pa = data["prefill_at"]
    cache = shard_kv_cache_tp(init_kv_cache(
        cfg, pa["tokens"].shape[0], pa["max_len"], True, device="cpu"), r, T)
    logits, cache = tp_prefill_at(
        qtp, torch.from_numpy(pa["tokens"]), cache, cfg,
        torch.from_numpy(pa["last_idx"]), torch.from_numpy(pa["offset"]),
        mesh)
    tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
    gen = torch.Generator().manual_seed(0)
    temps = torch.zeros(tok0.shape[0])
    toks, cache = tp_decode_chunk(qtp, tok0, cache, temps, gen, cfg, mesh,
                                  pa["n_tokens"])
    out["prefill_at"] = (logits.numpy(), tok0.numpy(), toks.numpy(),
                         cache.length.numpy())

    eng = TPDecodeEngine(q, cfg, mesh, max_batch=2, max_len=48,
                         device="cpu")
    rids = [eng.add_request(p, max_new_tokens=5) for p in data["prompts"]]
    got = eng.run()
    ext = eng.add_request(data["extension"], max_new_tokens=4)
    got2 = eng.run()
    out["engine"] = ([got[i] for i in rids], got2[ext], eng.prefix_hits,
                     eng.params_stacked is None and not eng._stacked_chunks,
                     tuple(eng.cache.k.shape))
    out["train"] = run_training(data["train"], world)
    dist.destroy_process_group()
    return out

