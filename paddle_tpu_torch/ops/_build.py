"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The kernels live in ``paddle_tpu_torch/csrc/*.cu`` and expose a plain C
interface (every pointer and the stream as ``void*``, sizes as ``int``), so
they compile in seconds without PyTorch's headers. The first call to
``library()`` compiles each source in its own nvcc process (all started
together), links the objects into one shared library under
``paddle_tpu_torch/csrc/build/`` named by a hash of the sources, the
headers they include (``csrc/*.cuh``) and the flags,
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
SOURCES = ("ragged_paged_attention.cu", "paged_decode_attention.cu",
           "flash_attention.cu", "flash_attention_wgmma.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every kernel entry point: (argtypes, restype int = the
# cudaError_t of the launch)
SIGNATURES = {
    # the ragged kernel: its tensors, then B, T, n_q, n_kv, d, page_size,
    # pages_per_seq and the form (0 span, 1 decode)
    "ragged_paged_attention_f32": [_P] * 7 + [_I] * 8 + [_F, _P],
    "ragged_paged_attention_i8": [_P] * 9 + [_I] * 8 + [_F, _P],
    "ragged_paged_attention_f8": [_P] * 7 + [_I] * 8 + [_F, _P],
    # the paged-decode kernel: its tensors, the workspace and the tickets,
    # then b, h, d, page_size, pages_per_seq, keys_per_split, n_splits
    "paged_decode_attention_f32": [_P] * 8 + [_I] * 7 + [_F, _P],
    # the flash kernels: their tensors, the five masking operands (mask,
    # kbias, qseg, kseg, block_mask; null = absent), then B, H, Sq, Sk, d,
    # the mask's heads and the block mask's block lengths
    "flash_attention_fwd_f32": [_P] * 10 + [_I] * 8 + [_F, _I, _P],
    "flash_attention_bwd_dq_f32": [_P] * 12 + [_I] * 8 + [_F, _I, _P],
    "flash_attention_bwd_dkv_f32": [_P] * 13 + [_I] * 8 + [_F, _I, _P],
    # their bf16 instantiations: the same arguments, q, k, v, o, do, dq,
    # dk and dv bf16 (lse, delta and the masks fp32)
    "flash_attention_fwd_bf16": [_P] * 10 + [_I] * 8 + [_F, _I, _P],
    "flash_attention_bwd_dq_bf16": [_P] * 12 + [_I] * 8 + [_F, _I, _P],
    "flash_attention_bwd_dkv_bf16": [_P] * 13 + [_I] * 8 + [_F, _I, _P],
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


def _inputs():
    """Every file a build reads: the sources and the headers in csrc."""
    return [CSRC / name for name in SOURCES] + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs():
        h.update(path.name.encode())
        h.update(path.read_bytes())
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


def refuse_interpret(name: str, interpret, t: torch.Tensor) -> None:
    """The JAX wrappers' ``interpret`` flag: None or False run as the
    device decides; True runs the plain version on a CPU tensor, which is
    what a CPU tensor runs anyway, and raises on a CUDA tensor, where the
    kernel has no interpreted mode."""
    if interpret and t.device.type == "cuda":
        raise ValueError(
            f"{name}(interpret=True): a CUDA kernel has no interpret mode; "
            "pass CPU tensors to run the plain version")


# 1-byte element types of quantized pools (the kernels read 4 at a time)
CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)


def require_launchable(name: str, floats, ints, codes=(), scales=(),
                       halves=()) -> None:
    """What every kernel here takes: fp32 float operands and int32 index
    operands, all contiguous, float operands 16-byte aligned (the kernels
    read them as float4); 1-byte code operands (int8 or float8_e4m3fn
    pools, one dtype) contiguous and 4-byte aligned (read 4 at a time);
    fp32 scale operands contiguous and 4-byte aligned (read one by one);
    bf16 operands (the flash kernels' bf16 instantiations) contiguous and
    16-byte aligned (read 8 at a time)."""
    if any(t.dtype != torch.bfloat16 for t in halves):
        raise TypeError(f"{name}: half operands must be bf16, got "
                        f"{[str(t.dtype) for t in halves]}")
    if not all(t.is_contiguous() for t in halves):
        raise ValueError(f"{name} needs contiguous operands")
    if any(t.data_ptr() % 16 for t in halves):
        raise ValueError(f"{name}: bf16 operands must be 16-byte aligned")
    if any(t.dtype != torch.float32 for t in (*floats, *scales)):
        raise TypeError(f"{name}: the CUDA kernel takes fp32 operands, got "
                        f"{[str(t.dtype) for t in (*floats, *scales)]}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: index operands must be int32, got "
                        f"{[str(t.dtype) for t in ints]}")
    if len({t.dtype for t in codes}) > 1 or any(
            t.dtype not in CODE_DTYPES for t in codes):
        raise TypeError(f"{name}: code operands must all be int8 or all "
                        f"float8_e4m3fn, got {[str(t.dtype) for t in codes]}")
    if not all(t.is_contiguous() for t in (*floats, *ints, *codes, *scales)):
        raise ValueError(f"{name} needs contiguous operands")
    if any(t.data_ptr() % 16 for t in floats):
        raise ValueError(f"{name}: float operands must be 16-byte aligned")
    if any(t.data_ptr() % 4 for t in (*codes, *scales)):
        raise ValueError(f"{name}: code and scale operands must be 4-byte "
                         "aligned")


# every LaunchCounts of the port, in creation order
_ALL_COUNTS = []


class LaunchCounts:
    """How often a kernel wrapper launched its CUDA kernel and how often it
    ran its plain PyTorch version instead (CPU tensors only). A run reads
    these to show which path it took. A wrapper with several kernel forms
    also counts each form's launches in ``form_launches``.

    The counts are taken in Python where a wrapper launches, so a CUDA
    graph's capture would add them once and its replays never: a captured
    step takes the counts its capture added back out (`counts_delta`,
    `counts_credit(delta, -1)`) and credits them on every replay."""

    def __init__(self):
        self.reset()
        _ALL_COUNTS.append(self)

    def reset(self) -> None:
        self.kernel_launches = 0
        self.plain_launches = 0
        self.form_launches = {}

    def count_kernel(self, form: str) -> None:
        self.kernel_launches += 1
        self.form_launches[form] = self.form_launches.get(form, 0) + 1


def counts_snapshot():
    """Every LaunchCounts' (kernel, plain, forms) as they stand."""
    return [(c.kernel_launches, c.plain_launches, dict(c.form_launches))
            for c in _ALL_COUNTS]


def counts_delta(before, after):
    """What the counts gained from one snapshot to a later one."""
    return [(k1 - k0, p1 - p0, {f: n - f0.get(f, 0) for f, n in f1.items()
                                if n != f0.get(f, 0)})
            for (k0, p0, f0), (k1, p1, f1) in zip(before, after)]


def counts_credit(delta, times: int = 1) -> None:
    """Add ``times`` x a `counts_delta` to the counts (negative undoes)."""
    for c, (k, p, forms) in zip(_ALL_COUNTS, delta):
        c.kernel_launches += times * k
        c.plain_launches += times * p
        for f, n in forms.items():
            c.form_launches[f] = c.form_launches.get(f, 0) + times * n
            if c.form_launches[f] == 0:
                del c.form_launches[f]
