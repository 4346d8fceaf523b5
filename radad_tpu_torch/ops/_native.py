"""Build and load the port's hand-written CUDA kernels.

Counterpart: none in ``radad_tpu`` (its Pallas kernels are compiled by
JAX). Each ``radad_tpu_torch/csrc/<name>.cu`` is compiled at first use by
its own ``nvcc`` process into ``radad_tpu_torch/build/lib<name>.so`` (a
git-ignored directory) for ``sm_90a``, with a plain C interface, and loaded
with ``ctypes``. No PyTorch headers are included, so a build takes seconds.
A library is rebuilt when its source is newer than it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# each library's C entries and their arguments, declared once at load;
# every entry returns a cudaError code
ENTRIES = {
    "gather_rows": {"radad_gather_rows": [_P] * 3 + [_I64] * 3 + [_P]},
    "exact_dot": {"radad_exact_dot": [_P] * 4 + [_I64] * 2 + [_I] * 4
                  + [_P]},
    "extract_candidates": {
        "radad_extract_candidates": [_P] * 5 + [_I64] + [_I] * 3 + [_P]},
    "fused_mha": {"radad_fused_mha": [_P] * 6 + [_I64] + [_I] * 3 + [_P],
                  "radad_fused_mha_bf16": [_P] * 6 + [_I64] + [_I] * 4
                  + [_P]},
    "flat_topk": {"radad_flat_topk": [_P] * 7 + [_I] * 8 + [_P]},
    "bias_gelu": {"radad_bias_gelu": [_P] * 3 + [_I64] * 3 + [_P]},
}
SOURCES = tuple(ENTRIES)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's stderr of the last build (ptxas register / spill report)
build_reports: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from radad_tpu_torch/csrc at first use")


def _paths(name: str):
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def _build_locked(names: Iterable[str]) -> None:
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:  # one nvcc per source, all started together
        src, lib = _paths(name)
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, lib, proc in procs:
        out, err = proc.communicate()
        build_reports[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{err}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every stale kernel library in ``names``, in parallel.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        _build_locked(list(names))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``lib<name>.so``, built first if needed,
    with its entries' signatures (``ENTRIES``) set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(_paths(name)[1])
            for entry, args in ENTRIES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = args, ctypes.c_int
            _libs[name] = lib
        return lib


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device "
                             f"(or all lie on the CPU), got "
                             f"{[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise if a kernel's C entry returned a non-zero cudaError code."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
