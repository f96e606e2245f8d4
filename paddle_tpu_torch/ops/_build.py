"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The kernels live in ``paddle_tpu_torch/csrc/*.cu`` and expose a plain C
interface (every pointer and the stream as ``void*``, sizes as ``int``), so
they compile in seconds without PyTorch's headers. The first call to
``library()`` compiles each source in its own nvcc process (all started
together), links the objects into one shared library under
``paddle_tpu_torch/csrc/build/`` named by a hash of the sources and flags,
and loads it. A later process finds the library by that name and skips the
build. Nothing here runs at import time: the CPU tests import every module
on a machine without nvcc.
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
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("ragged_paged_attention.cu", "paged_decode_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every kernel entry point: (argtypes, restype int = the
# cudaError_t of the launch)
SIGNATURES = {
    "ragged_paged_attention_f32": [_P] * 7 + [_I] * 7 + [_F, _P],
    "paged_decode_attention_f32": [_P] * 6 + [_I] * 5 + [_F, _P],
}


class BuildInfo:
    """What the last build did: the library path, the seconds it took
    (0.0 when an earlier build was reused) and nvcc's messages (ptxas
    register and shared-memory reports included)."""

    def __init__(self):
        self.path: Optional[Path] = None
        self.seconds = 0.0
        self.log = ""


BUILD = BuildInfo()
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are built from paddle_tpu_torch/csrc at "
            "first use and need the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels unless a library of the same sources
    exists; return its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    lib = BUILD_DIR / f"libpaddle_tpu_torch_{tag}.so"
    BUILD.path = lib
    if lib.exists():
        BUILD.seconds = 0.0
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== nvcc {name} (rc={p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(name)
    BUILD.log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD.log}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    BUILD.seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def require_launchable(name: str, floats, ints) -> None:
    """What every kernel here takes: fp32 float operands and int32 index
    operands, all contiguous, float operands 16-byte aligned (the kernels
    read them as float4)."""
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{name}: the CUDA kernel takes fp32 q and pools, "
                        f"got {[str(t.dtype) for t in floats]}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: index operands must be int32, got "
                        f"{[str(t.dtype) for t in ints]}")
    if not all(t.is_contiguous() for t in (*floats, *ints)):
        raise ValueError(f"{name} needs contiguous operands")
    if any(t.data_ptr() % 16 for t in floats):
        raise ValueError(f"{name}: float operands must be 16-byte aligned")


class LaunchCounts:
    """How often a kernel wrapper launched its CUDA kernel and how often it
    ran its plain PyTorch version instead (CPU tensors only). A run reads
    these to show which path it took."""

    def __init__(self):
        self.kernel_launches = 0
        self.plain_launches = 0

    def reset(self) -> None:
        self.kernel_launches = 0
        self.plain_launches = 0
