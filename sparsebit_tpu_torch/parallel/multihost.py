"""Process-group setup and the per-rank batch slice (port of
``sparsebit_tpu/parallel/multihost.py``), plus ``spawn_ranks``, which
starts the ranks of one host as processes.

The reference's ``jax.distributed.initialize`` becomes
``torch.distributed.init_process_group``. The backend is explicit: NCCL
on ``cuda``, gloo on ``cpu``, or the one the caller names (gloo on
``cuda`` lets two ranks share one card, which NCCL refuses). Nothing here
changes backend or device by itself; a failed rendezvous or collective
raises.

    initialize_multihost()                  # torchrun's variables
    mesh = make_mesh(dp=1, tp=T)            # one process per rank
    params_tp = shard_llama_params_tp_packed(..., rank=tp_rank)
    logits, cache = tp_decode_step(params_tp, tok, cache, cfg, mesh)
"""

import datetime
import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist

from sparsebit_tpu_torch import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
TIMEOUT_S = 600  # a rendezvous or collective that waits longer raises


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, *, backend=None, device=None):
    """Join the default process group; returns (rank, world_size).

    With no address the rendezvous comes from the variables ``torchrun``
    sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE). On ``cuda`` (the
    default device) the rank's card is ``device``'s index when it names
    one, else LOCAL_RANK's when set; ``backend`` defaults to NCCL there
    and to gloo on ``cpu``."""
    device = resolve_device(device)
    if coordinator_address is None:
        env = os.environ
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if k not in env]
        if missing:
            raise RuntimeError("initialize_multihost: no address given and "
                               "{} unset".format(", ".join(missing)))
        coordinator_address = "{}:{}".format(env["MASTER_ADDR"],
                                             env["MASTER_PORT"])
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    if device.type == "cuda":
        if device.index is not None:
            torch.cuda.set_device(device.index)
        elif "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        backend or BACKENDS[device.type],
        init_method="tcp://{}".format(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def local_batch_slice(global_batch, mesh, axis="dp"):
    """Rows of the global batch this rank owns under a batch sharded over
    ``axis`` (contiguous shards in mesh order). The axis must divide the
    batch, as the reference's shard_map over P("dp") requires: a remainder
    raises instead of dropping rows."""
    n = mesh[axis].size()
    if global_batch % n:
        raise ValueError("{} rows over {} ranks of axis {!r}".format(
            global_batch, n, axis))
    per = global_batch // n
    idx = mesh.get_local_rank(axis)
    return slice(idx * per, (idx + 1) * per)


def free_port():
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(rank, fn, args, outdir):
    # the result goes back through a file, pickled by value: a queue's
    # pipe would hold a rank whose result outgrows its buffer until the
    # parent reads, and the parent reads once every rank has exited
    with open(os.path.join(outdir, str(rank)), "wb") as f:
        pickle.dump(fn(rank, *args), f)


def spawn_ranks(fn, nprocs, args=()):
    """Run ``fn(rank, *args)`` in ``nprocs`` processes started by
    ``torch.multiprocessing.spawn`` and return their results in rank
    order. ``fn`` must be importable (a module-level function) and its
    result picklable; tensors come back by value. A rank that fails stops
    the others and raises here with its traceback; a collective that
    hangs raises after initialize_multihost's TIMEOUT_S."""
    with tempfile.TemporaryDirectory() as outdir:
        torch.multiprocessing.spawn(_run_rank, args=(fn, args, outdir),
                                    nprocs=nprocs, join=True)
        out = []
        for rank in range(nprocs):
            with open(os.path.join(outdir, str(rank)), "rb") as f:
                out.append(pickle.load(f))
    return out
