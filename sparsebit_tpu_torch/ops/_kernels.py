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

# C signatures: every function returns cudaError_t as int
SIGNATURES = {
    # quant_matmul.cu (K1)
    "sbt_qmm_s4": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    # ffn_fused.cu (K3)
    "sbt_ffn_prologue": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sbt_ffn_w13_glu": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "sbt_ffn_w2_resid": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                         _P],
    # attention.cu (K2)
    "sbt_attn_update": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _F, _P],
    # matvec.cu (K9)
    "sbt_bf16_matvec": [_P, _P, _P, _I, _I, _I, _P],
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
