"""Build and load the port's CUDA kernels.

All kernels live in ``sparsebit_tpu_torch/csrc/*.cu`` behind a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds, not minutes).
At first use each source is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library under ``csrc/build/`` named by a hash of the sources and flags;
the library is loaded with ``ctypes``. Every C entry point launches on the
caller's stream and returns ``cudaGetLastError()``; ``check`` raises when
that is not 0.

Nothing here runs at import: the CPU tests import every module.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signatures: every function returns cudaError_t as int
SIGNATURES = {
    # quant_matmul.cu (K1) (+ groups a K split, its partials' scratch)
    "sbt_qmm_s4": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    # ffn_fused.cu (K3): x, nw, 6 weight/qparam arrays, out, 6 scratch
    # buffers; sz_bf16, nw_bf16, B, dim, F, gs and the K-split plan
    "sbt_ffn_block": [_P] * 15 + [_I] * 8 + [_F, _P],
    # attention.cu (K2) (+ the cluster size)
    "sbt_attn_update": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _F, _I, _P],
    # decode_attention.cu (K5)
    # (+ scratch: split partials, rows per split)
    "sbt_decode_attention": [_P] * 7 + [_I] * 6 + [_F, _P, _P, _I, _P],
    # quant_matmul_planes.cu (K6, K7, K8)
    # (+ the plan: rows a thread, byte columns a block, groups a K split;
    # scratch: the split partials)
    "sbt_qmm_planes": [_P, _I, _P, _I, _P, _I, _I, _P, _P, _I, _P] + [_I] * 7
    + [_P, _P],
    # matvec.cu (K9)
    # (+ scratch: K-split partials, splits)
    "sbt_bf16_matvec": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    # layer_fused.cu (K4): 12 weight/qparam stacks, 2 norms, 4 cache
    # pools, bt, pos, cos, sin, x, 12 scratch buffers; 24 ints (W2's rows
    # a layer and the s4r K-split plan among them), 2 floats
    "sbt_layers_fused": [_P] * 35 + [_I] * 24 + [_F, _F, _P],
    # flash_attention.cu (K10): q, k, v, out, lse (or null); dtype, B, H,
    # Hkv, S, D; sm_scale; q, k, v, out's (batch, head, row) strides
    "sbt_flash_attention": [_P] * 5 + [_I] * 6 + [_F] + [_L] * 12 + [_P],
    # (K11): q, k, v, dO, lse, di, dk, dv; as K10; q, k, v, dO, dk, dv's
    # strides
    "sbt_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_F] + [_L] * 18 + [_P],
    # (K12): q, k, v, dO, lse, di, dq; as K10; q, k, v, dO, dq's strides
    "sbt_flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_F] + [_L] * 15 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cand = []
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cand.append(found)
    for c in cand:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME={})".format(CUDA_HOME))


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest():
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build():
    """Compile every ``csrc/*.cu`` (in parallel) and link the shared
    library, unless a library built from the same sources exists. Returns
    its path."""
    sources = _sources()
    tag = _digest()
    lib_path = BUILD_DIR / "libsbt_kernels_{}.so".format(tag)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sources:
        # per-process names: concurrent first uses must not share objects
        obj = BUILD_DIR / "{}_{}_{}.o".format(src.stem, tag, os.getpid())
        objs.append(obj)
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
               "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append("{}:\n{}".format(src.name, out))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = lib_path.with_suffix(".so.tmp{}".format(os.getpid()))
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err, name):
    if err != 0:
        raise RuntimeError("{} launch failed: cudaError {}".format(name, err))


def stream():
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """Streaming multiprocessors of a CUDA device (grid sizing)."""
    return _sm_count(device.index if device.index is not None else 0)


def require_cuda(name, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device (the kernels take raw pointers and row-major strides)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("{}: all operands must be on {} (got {})".format(
                name, dev, t.device))
        if not t.is_contiguous():
            raise ValueError("{}: operands must be contiguous".format(name))
