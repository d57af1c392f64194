"""Profiling helpers (port of ``sparsebit_tpu/utils/profiling.py``; the
reference has no runtime profiler, SURVEY section 5).

``trace`` records ``torch.profiler``'s CPU activity and, while CUDA is
available, the card's kernels, and writes a Chrome trace into ``logdir``
(open it in chrome://tracing or Perfetto). ``wall_timer`` measures a
region on the host's clock after waiting for the device, since CUDA calls
return before their kernels finish.
"""

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the block: ``with trace(dir) as prof: run_workload()``.
    Yields the ``torch.profiler.profile`` (its ``key_averages()`` sums
    the ops and kernels); on exit the trace is written to
    ``logdir/trace.json`` (default: a new directory under the temporary
    directory), whose path ``prof.trace_path`` holds."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = logdir or tempfile.mkdtemp(prefix="sparsebit_tpu_torch_trace_")
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(logdir, "trace.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def _synchronize(sync):
    """Wait for the device work behind ``sync``: a tensor (or a callable
    returning one, or a sequence of them) waits on its own device; ``True``
    waits on the current CUDA device."""
    if callable(sync):
        sync = sync()
    if sync is True:
        torch.cuda.synchronize()
        return
    for t in (sync if isinstance(sync, (list, tuple)) else [sync]):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def wall_timer(label="block", sync=None):
    """Wall-clock a region: ``with wall_timer("fwd", sync=True) as box:
    ...``. ``sync``: a tensor, a callable returning one, a sequence of
    tensors, or ``True`` for the current CUDA device: the device work is
    waited for before the clock stops. Fills ``box["seconds"]`` and prints
    ``[label] ms``."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if sync is not None:
            _synchronize(sync)
        box["seconds"] = time.perf_counter() - t0
        print("[{}] {:.3f} ms".format(label, box["seconds"] * 1e3))
