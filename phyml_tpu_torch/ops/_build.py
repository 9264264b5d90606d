"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

The kernels have a plain C interface and are compiled by `nvcc` into
one shared library, loaded with ctypes (no PyTorch headers, so a
build takes seconds).  The library lands in `phyml_tpu_torch/build/`
under a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused.  Nothing here runs at import time:
the first kernel launch calls `library()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# full IEEE float32: no --use_fast_math (flush-to-zero and approximate
# logf/expf would change the results); -Xptxas -v records registers,
# shared memory and spills in the build log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argtypes (every function returns an int error
# code: 0, a cudaError_t, or -1 for an unsupported (ns, C) shape)
_SIGNATURES = {
    # sched tips pmats pi logw out | n_int n_slots ns C P tp | stream
    "phyml_slot_site_lse": [_P] * 6 + [_I] * 6 + [_P],
    # child tips pmats pi logw out ws_pup ws_sc
    # | n_otu n_int ns C P Pw B tp | stream
    "phyml_dense_site_lse": [_P] * 8 + [_I] * 8 + [_P],
    # child tips pmats V Vinv pi d scd ws_clv ws_sc ws_out ws_sco
    # | n_otu n_int ns C P Pw tp | stream
    "phyml_edge_dotprods": [_P] * 12 + [_I] * 7 + [_P],
}


def sources() -> list[str]:
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16],
                        "libphyml_kernels.so")


def build() -> str:
    """Compile the kernels if their library is missing; returns its
    path.  The compiler's report goes to build.log beside it."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in sources() if s.endswith(".cu")]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(os.path.dirname(so), "build.log"), "w") as fh:
        fh.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a kernel launcher's nonzero return code."""
    if rc == -1:
        raise NotImplementedError(
            f"{name}: no CUDA kernel for this state count / class count "
            "(ns=4 with at most 32 classes is built; amino acids are "
            "ROADMAP.md Queue 1, 'AA kernels')")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with "
                           f"cudaError {rc}")


def block_patterns(C: int) -> int:
    """Patterns per thread block (block = patterns x classes): about
    128 threads, at least one warp of patterns."""
    return 32 * max(1, 4 // C)


def check_operands(name: str, ints=(), floats=()) -> None:
    """The CUDA launchers take contiguous int32 / float32 tensors on
    one CUDA device."""
    dev = floats[0].device
    for t, want in [(t, torch.int32) for t in ints] + \
            [(t, torch.float32) for t in floats]:
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"{name}: operands must be contiguous {want} tensors on "
                f"{dev}, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
