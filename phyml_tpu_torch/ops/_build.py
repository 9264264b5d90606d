"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

The kernels have a plain C interface; `nvcc` compiles each source
file in its own process, all at once, and links them into one shared
library, loaded with ctypes (no PyTorch headers, so a build takes
seconds).  The library lands in `phyml_tpu_torch/build/`
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argtypes (every function returns an int error
# code: 0, a cudaError_t, or -1 for an unsupported (ns, C) shape)
_SLOT_ARGS = [_P] * 6 + [_I] * 6 + [_P]
_EDOTP_ARGS = [_P] * 12 + [_I] * 7 + [_P]
_SIGNATURES = {
    # sched tips pmats pi logw out | n_int n_slots ns C P tp | stream
    "phyml_slot_site_lse": _SLOT_ARGS,          # K1
    "phyml_slot_site_lse_stream": _SLOT_ARGS,   # K4
    # child tips pmats pi logw out ws_pup ws_sc
    # | n_otu n_int ns C P Pw B tp | stream
    "phyml_dense_site_lse": [_P] * 8 + [_I] * 8 + [_P],   # K3
    # child tips pmats V Vinv pi d scd ws_clv ws_sc ws_out ws_sco
    # | n_otu n_int ns C P Pw tp | stream
    "phyml_edge_dotprods": _EDOTP_ARGS,         # K2
    "phyml_edge_dotprods_stream": _EDOTP_ARGS,  # K5
}
# state counts the kernels are instantiated for (DNA, amino acids)
KERNEL_NS = (4, 20)


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
    out_dir = os.path.dirname(so)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", src, "-o",
             os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")]
            for src in sources() if src.endswith(".cu")]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    tmp = f"{so}.{tag}"
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
            *[cmd[-1] for cmd in cmds]]
    log, failed = [], None
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, out)
    if failed is None:
        res = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed = (res.returncode, res.stderr)
    for cmd in cmds:
        if os.path.exists(cmd[-1]):
            os.remove(cmd[-1])
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        fh.write("".join(log))
    if failed is not None:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                           f"{failed[1][-4000:]}")
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


def check(rc: int, name: str, ns: int) -> None:
    """Raise on a kernel launcher's nonzero return code."""
    if rc == -1 and ns not in KERNEL_NS:
        raise NotImplementedError(
            f"{name}: no CUDA kernel for {ns} states (the kernels are "
            f"built for ns in {KERNEL_NS}; other state counts are "
            "ROADMAP.md Queue 1, 'Other state counts')")
    if rc == -1:
        raise NotImplementedError(
            f"{name}: no CUDA kernel for this shape (more than 32 rate "
            "classes, a batch over 65535, or more shared memory than a "
            "block may use)")
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


def check_aligned(name: str, *tensors) -> None:
    """The streamed kernels copy these operands into shared memory in
    16-byte pieces (cp.async.cg), so each must start 16-byte aligned."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not 16-byte aligned; pass a fresh "
                             "contiguous tensor")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
