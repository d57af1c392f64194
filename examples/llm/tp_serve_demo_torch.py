"""Tensor-parallel quantized decode demo on the PyTorch/CUDA port (the
port's examples/llm/tp_serve_demo.py).

Shards packed INT4 weights and the INT8 KV cache over the "tp" axis of a
mesh and runs greedy decode steps, one process per rank. It starts its
own ranks (torch.multiprocessing, spawn) unless it runs under torchrun:

    python tp_serve_demo_torch.py --tp 2 --device cpu        # gloo, CPU
    torchrun --nproc_per_node 2 tp_serve_demo_torch.py --tp 2  # NCCL, 2 cards
    python tp_serve_demo_torch.py --tp 2 --backend gloo      # 2 ranks, 1 card

Rank 0 prints the mesh and the decoded tokens.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))

import argparse
import os

import torch
import torch.distributed as dist

from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.decode import prefill
from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
from sparsebit_tpu_torch.parallel.mesh import make_mesh
from sparsebit_tpu_torch.parallel.multihost import (
    free_port,
    initialize_multihost,
    spawn_ranks,
)
from sparsebit_tpu_torch.parallel.tp import (
    shard_kv_cache_tp,
    shard_llama_params_tp,
    tp_decode_step,
    tp_group,
)


def demo_config():
    return L.llama_tiny(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=256, max_seq_len=64,
                        dtype="float32")


def demo_params(cfg, device):
    """The demo's weights: init_llama_params from a generator on
    ``device`` seeded 0, the same on every rank."""
    g = torch.Generator(device=device).manual_seed(0)
    return L.init_llama_params(cfg, g, device=device)


def serve(args, address=None, rank=None):
    """One rank: join the group, shard, prefill on the unsharded params,
    shard the cache, greedy tp_decode_step. Returns the decoded tokens
    (2, tokens) on the CPU."""
    device = torch.device(args.device)
    if address is None:  # torchrun's variables
        initialize_multihost(backend=args.backend, device=device)
    else:
        initialize_multihost(address, args.tp, rank, backend=args.backend,
                             device=device)
    try:
        mesh = make_mesh(dp=1, tp=args.tp, device_type=device.type)
        _, T, r = tp_group(mesh)
        cfg = demo_config()
        params = demo_params(cfg, device)
        params_tp = shard_llama_params_tp(params, cfg, T, bits=args.bits,
                                          groupsize=32, rank=r)
        if dist.get_rank() == 0:
            print("mesh:", dict(zip(mesh.mesh_dim_names, mesh.shape)),
                  "| per-shard packed INT{} weights | backend {}".format(
                      args.bits, dist.get_backend()))
        prompt = torch.ones((2, 5), dtype=torch.long, device=device)
        cache = init_kv_cache(cfg, 2, 32, True, device=device)
        logits, cache = prefill(params, prompt, cache, cfg)  # unsharded
        cache = shard_kv_cache_tp(cache, r, T)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = []
        for _ in range(args.tokens):
            logits, cache = tp_decode_step(params_tp, tok, cache, cfg, mesh)
            # the vocab shards' maxima, gathered: each rank holds V/T
            parts = [torch.empty_like(logits) for _ in range(T)]
            dist.all_gather(parts, logits.contiguous(), group=mesh.get_group(
                "tp"))
            tok = torch.argmax(torch.cat(parts, dim=-1), dim=-1).to(
                torch.int32)
            out.append(tok)
        toks = torch.stack(out, dim=1).cpu()
        if dist.get_rank() == 0:
            print("decoded:", toks.tolist(), flush=True)
        return toks
    finally:
        dist.destroy_process_group()


def _spawned(rank, args, address):
    return serve(args, address, rank)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl (default on cuda) or gloo (default on cpu; "
                         "two ranks on one card)")
    args = ap.parse_args(argv)
    if "RANK" in os.environ:
        return serve(args)
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in _sys.path:  # the spawned ranks import this module
        _sys.path.insert(0, here)
    return spawn_ranks(_spawned, args.tp,
                       args=(args, "localhost:{}".format(free_port())))[0]


if __name__ == "__main__":
    main()
