"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` exports a plain C interface and compiles on its own
into `build/kernels/<name>-<hash>.so` at the root of the checkout (listed in
`.gitignore`)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

No PyTorch header is included, so a build takes seconds.  The hash covers the
source, the shared headers (`csrc/*.cuh`) and the flags, so a library is
rebuilt only when its code changes.
All sources that need a build compile at once, one nvcc process each.
Pointers go to the C functions as `ctypes.c_void_p`, and so does the CUDA
stream (`torch.cuda.current_stream().cuda_stream`); every C entry point
returns `cudaGetLastError()` after its launch, and `check` raises on a
non-zero code.  Nothing here runs at import: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_U = ctypes.c_uint32
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_int64)
# C signatures per source file, as exported by csrc/<name>.cu.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "floa_aggregate": {
        "floa_aggregate_batched": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I,
                                   _I, _I, _P],
        "floa_step_batched": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                              _I, _I, _I, _I, _P],
    },
    "grad_stats": {
        "grad_stats": [_P, _P, _L, _L, _I, _I, _P],
        "grad_stats_segments": [_P, _P, _P, _L, _L, _P, _L, _L, _I, _P],
        "grad_stats_max_cluster": [_I],
    },
    "defense_sort": {
        "sort_columns": [_P, _P, _I, _I, _L, _I, _P],
        "sort_columns_bitonic": [_P, _P, _I, _I, _I, _I, _I, _L, _I, _P],
    },
    "decode_attention": {
        "decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _P],
        "decode_attention_occupancy": [_I, _I],
    },
    "noisy_update": {
        "noisy_sgd": [_P, _P, _P, _P, _P, _P, _F, _I, _P, _U, _I, _LP, _LP,
                      _LP, _I, _P],
        "counter_trunc_normal": [_P, _F, _F, _F, _U, _U, _U, _I, _LP, _LP,
                                 _LP, _I, _P],
    },
    "philox_check": {
        "philox_raw": [_P, _P, _P, _L, _I, _P],
    },
}

# dtype codes shared with the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # the shared device code
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.

    Returns {"seconds": wall time, "built": [names compiled now],
    "ptxas": {name: [ptxas -v lines: entry, registers/smem, spills]}}; the
    lines come from the build log kept beside each library, so a cached
    build reports them too."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SIGNATURES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    ptxas: Dict[str, List[str]] = {}
    for name in SIGNATURES:
        log = _target(name).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines
                       if "Compiling entry" in ln or "Used" in ln
                       or "spill" in ln]
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "ptxas": ptxas}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def need(cond: bool, msg: str) -> None:
    """Raise ValueError(msg) unless cond: the wrappers' input checks, made
    before any pointer reaches a kernel."""
    if not cond:
        raise ValueError(msg)


def check_tensor(name: str, x, shape: tuple, dtypes, device) -> None:
    """x must be a contiguous tensor of `shape`, one of `dtypes`, on
    `device`: what the kernels take.  The messages are built only when a
    check fails (the wrappers run once per layer per decode step)."""
    if (isinstance(x, torch.Tensor) and x.shape == shape and x.dtype in dtypes
            and x.device == device and x.is_contiguous()):
        return
    need(isinstance(x, torch.Tensor), f"{name} must be a tensor")
    need(tuple(x.shape) == tuple(shape),
         f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    need(x.dtype in dtypes, f"{name} has dtype {x.dtype}, expected one of "
         f"{[str(d) for d in dtypes]}")
    need(x.device == device, f"{name} is on {x.device}, expected {device}")
    need(x.is_contiguous(), f"{name} must be contiguous")


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
