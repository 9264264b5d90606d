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
import re
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
# Shared memory one block may use on Hopper (common.cuh kMaxSmem)
MAX_BLOCK_SMEM = 232448

# C signatures: name -> argtypes (every function returns an int error
# code: 0, a cudaError_t, or -1 for an unsupported (ns, C) shape)
_SLOT_ARGS = [_P] * 6 + [_I] * 7 + [_P]
_EDOTP_ARGS = [_P] * 10 + [_I] * 7 + [_P]
_SIGNATURES = {
    # sched tips pmats pi logw out | n_otu n_int n_slots ns C P ldt
    # | stream
    "phyml_slot_site_lse": _SLOT_ARGS,          # K1
    "phyml_slot_site_lse_stream": _SLOT_ARGS,   # K4
    # ns C n_otu n_slots | blocks per SM (int*)
    "phyml_slot_site_lse_occupancy": [_I] * 4 + [_P],
    "phyml_slot_site_lse_stream_occupancy": [_I] * 4 + [_P],
    # sched tips pmats pi logw out | n_otu n_int n_slots ns C P B
    # per_entry_sched shared_params | stream
    "phyml_batched_uppass": [_P] * 6 + [_I] * 9 + [_P],   # K3
    # ns C n_slots | blocks per SM (int*)
    "phyml_batched_uppass_occupancy": [_I] * 3 + [_P],
    # child tips pmats V Vinv pi d scd ws_clv ws_out
    # | n_otu n_int ns C P Pw R | stream
    "phyml_edge_dotprods": _EDOTP_ARGS,         # K2
    "phyml_edge_dotprods_stream": _EDOTP_ARGS,  # K5
    # ns | blocks per SM (int*)
    "phyml_edge_dotprods_occupancy": [_I, _P],
    "phyml_edge_dotprods_stream_occupancy": [_I, _P],
    # d sc t_in mask wts lam w pinv inv_lk invar_ok | out | strides
    # (int64[12]) | rows lead_b C ns P iters invar w_group | stream
    "phyml_edge_newton": [_P] * 12 + [_I] * 8 + [_P],       # K6
    "phyml_edge_newton_sums": [_P] * 12 + [_I] * 8 + [_P],  # K6, sums
    # rows P C ns | cluster, resident blocks, SMs (int[3])
    "phyml_edge_newton_geometry": [_I] * 4 + [_P],
}


def _read_ladder() -> dict:
    """The state-count ladder of csrc/ladder.cuh, read from the table the
    kernels are instantiated from: rung -> its register tiles {"slot":
    (R, Q), "batch": (R, Q), "edotp": (R, Q)} of K1/K4, K3 and K2/K5."""
    with open(os.path.join(_CSRC, "ladder.cuh")) as fh:
        text = fh.read()
    table = text[text.index("#define PHYML_LADDER(X)"):]
    table = table[:table.index("namespace")]
    rungs = {}
    for row in re.findall(r"X\(([\d,\s]+)\)", table):
        ns, sr, sq, br, bq, er, eq = (int(v) for v in row.split(","))
        rungs[ns] = {"slot": (sr, sq), "batch": (br, bq),
                     "edotp": (er, eq)}
    return rungs


# the rungs every kernel is instantiated for (a problem's state count is
# padded up to the next: rung); past the top one the big bodies run
RUNGS = _read_ladder()
LADDER = tuple(sorted(RUNGS))


def _read_big(header: str = "big.cuh", prefix: str = "kBig") -> dict:
    """The big bodies' constants, read from the literal `constexpr`
    lines of a header.  csrc/big.cuh (K3/K4's 3xTF32 walk): kBigPanel
    (ns is padded to a multiple), kBigWarpCols (a warp's pattern
    columns), kBigChunk (contraction states of a staged piece),
    kBigStages (the ring's stages), kBigTileWide / kBigTileNarrow (a
    block's tile), kBigPadN (row padding of tiles and pieces),
    kBigTwoBlocks (the shared memory of a block that leaves two blocks
    an SM) and kBigClusterMax (the classes K3/K4 spread over a cluster
    at most).  csrc/big_ffma.cuh (K5's FFMA walk, prefix "kFfma"):
    kFfmaWarpCols (a warp's pattern columns), kFfmaMaxWarps (the warps
    on a block's columns at most), kFfmaPair (the output states of a
    pair, a warp's tile) and kFfmaStages (the ring's stages)."""
    with open(os.path.join(_CSRC, header)) as fh:
        text = fh.read()
    return {name: int(v) for name, v in re.findall(
        r"constexpr (?:int|size_t) (%s\w+) = (\d+);" % prefix, text)}


# Past the ladder's top rung the big bodies take any state count padded
# to a multiple of BIG_PANEL.  A K3/K4 block (csrc/big.cuh) holds
# BIG_TILES[0] patterns, or BIG_TILES[1] where that leaves one block an
# SM, and one warp per BIG_WARP_COLS of them; a K5 block
# (csrc/big_ffma.cuh) one warp per BIG_FFMA_WARP_COLS patterns, at most
# BIG_FFMA_MAX_WARPS of them, and one that stages its ring
BIG = _read_big()
BIG_FFMA = _read_big("big_ffma.cuh", "kFfma")
BIG_FFMA_WARP_COLS = BIG_FFMA["kFfmaWarpCols"]
BIG_FFMA_MAX_WARPS = BIG_FFMA["kFfmaMaxWarps"]
BIG_FFMA_PAIR = BIG_FFMA["kFfmaPair"]
BIG_FFMA_STAGES = BIG_FFMA["kFfmaStages"]
BIG_PANEL = BIG["kBigPanel"]
BIG_WARP_COLS = BIG["kBigWarpCols"]
BIG_CHUNK = BIG["kBigChunk"]
BIG_STAGES = BIG["kBigStages"]
BIG_TILES = (BIG["kBigTileWide"], BIG["kBigTileNarrow"])
BIG_PAD_N = BIG["kBigPadN"]
BIG_TWO_BLOCKS = BIG["kBigTwoBlocks"]
# classes at most that K3/K4 spread over a cluster of one-class blocks
BIG_CLUSTER_MAX = BIG["kBigClusterMax"]
# floats of a staged piece: one m-tile by BIG_CHUNK states (rows padded
# by BIG_PAD_N)
BIG_PIECE_N = BIG_PANEL * (BIG_CHUNK + BIG_PAD_N)
# floats of the mbarriers in front of the ring (full and empty a stage)
BIG_BAR_FLOATS = 4 * BIG_STAGES


def big_pass_smem(NS: int, C: int, n_slots: int, T: int) -> int:
    """Bytes of shared memory of a K3/K4 big block of tile T
    (csrc/big_slots.cu: big_pass_smem): the mbarriers, the ring of
    BIG_STAGES stages of two plain pieces, n_slots slots of T x (NS +
    BIG_PAD_N) + T (the log2 scales), two tip tiles and C x T class
    terms."""
    ld = NS + BIG_PAD_N
    return 4 * (BIG_BAR_FLOATS + BIG_STAGES * 2 * BIG_PIECE_N
                + n_slots * (T * ld + T) + 2 * T * ld + C * T)


def big_pass_tile(NS: int, C: int, n_slots: int) -> int:
    """K3/K4's tile past the ladder: BIG_TILES[0] patterns where the
    block then leaves two blocks an SM, else BIG_TILES[1]
    (csrc/big_slots.cu: big_pass_tile)."""
    wide, narrow = BIG_TILES
    return wide if big_pass_smem(NS, C, n_slots, wide) <= BIG_TWO_BLOCKS \
        else narrow


def big_edotp_floats(NS: int, W: int, resident: bool) -> int:
    """Floats of shared memory of K5's big block of W warps at NS
    (padded) states (csrc/big_ffma.cuh: ffma_smem_floats): the
    mbarriers, the ring (BIG_FFMA_STAGES stages of two pieces of
    BIG_FFMA_PAIR x 16), V and V^-1 where resident, and each warp's
    tiles: three of (NS + 1) x 16 and one of NS x 16."""
    return (4 * BIG_FFMA_STAGES + BIG_FFMA_STAGES * 2 * BIG_FFMA_PAIR * 16
            + (2 * NS * NS if resident else 0)
            + W * BIG_FFMA_WARP_COLS * (4 * NS + 3))


def big_edotp_warps(NS: int) -> int:
    """Warps on the columns of K5's big block at NS (padded) states: the
    most, up to BIG_FFMA_MAX_WARPS, whose block fits MAX_BLOCK_SMEM with
    V and V^-1 streamed (csrc/big_ffma.cuh: ffma_warps; 0 where none
    fits)."""
    for W in range(BIG_FFMA_MAX_WARPS, 0, -1):
        if 4 * big_edotp_floats(NS, W, False) <= MAX_BLOCK_SMEM:
            return W
    return 0


def big_edotp_resident(NS: int) -> bool:
    """True where K5's big block keeps V and V^-1 in shared memory: the
    block then still leaves two blocks an SM (csrc/big_ffma.cuh:
    ffma_resident)."""
    W = big_edotp_warps(NS)
    return W > 0 and 4 * big_edotp_floats(NS, W, True) <= BIG_TWO_BLOCKS


def big_edotp_smem(NS: int) -> int:
    """Bytes of shared memory of K5's big block (csrc/big_edotp.cu:
    big_edotp_smem); where no block fits, a block of one warp's, which
    the launcher refuses."""
    return 4 * big_edotp_floats(NS, max(1, big_edotp_warps(NS)),
                                big_edotp_resident(NS))


def rung(ns: int) -> int:
    """The state count the kernels run ns at: the smallest rung of the
    ladder holding ns states, or past the top rung ns rounded up to a
    multiple of BIG_PANEL (the big bodies, `is_big`)."""
    for r in LADDER:
        if ns <= r:
            return r
    return -(-ns // BIG_PANEL) * BIG_PANEL


def is_big(NS: int) -> bool:
    """True where a padded state count runs the big bodies."""
    return NS > LADDER[-1]


def tile(family: str, ns: int) -> int:
    """Patterns one block's warp covers at the rung of ns: 32 / G * Q with
    G = rung / R lanes per pattern column (family "slot", "batch" or
    "edotp").  Past the ladder a big block's tile: K5's ("edotp",
    BIG_FFMA_WARP_COLS patterns a warp), or the widest K3/K4 may take
    ("slot", "batch": it also depends on the slots, big_pass_tile)."""
    NS = rung(ns)
    if is_big(NS):
        return BIG_FFMA_WARP_COLS * max(1, big_edotp_warps(NS)) \
            if family == "edotp" else BIG_TILES[0]
    R, Q = RUNGS[NS][family]
    return 32 // (NS // R) * Q


def pad_states(t, NS: int, dims: tuple):
    """t with each axis in dims (the state axes) zero-padded to NS
    entries; t itself when it has NS already.  A padded state has a zero
    row and column in every P-matrix, V and V^-1 and a zero in pi and
    the tips, so it adds nothing to any sum the kernels take."""
    ns = t.shape[dims[0]]
    if ns == NS:
        return t
    shape = list(t.shape)
    for d in dims:
        shape[d] = NS
    out = t.new_zeros(shape)
    out[tuple(slice(0, ns) if d in dims else slice(None)
              for d in range(t.dim()))] = t
    return out


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


def check(rc: int, name: str, ns: int, **shape) -> None:
    """Raise on a kernel launcher's nonzero return code (the wrappers
    launch at `rung(ns)`); the refusal (-1) names the shape, ns and the
    `shape` the wrapper passes (classes, slots, patterns, the block's
    shared memory from its geometry)."""
    if rc == -1:
        dims = ", ".join([f"ns={ns}"] + [f"{k}={v}" for k, v in shape.items()])
        raise NotImplementedError(
            f"{name}: no CUDA kernel for this shape ({dims}): more than 32 "
            "rate classes, a batch over 65535, more than 65535 pattern "
            f"tiles, or more shared memory than a block may use "
            f"({MAX_BLOCK_SMEM} B)")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with "
                           f"cudaError {rc}")


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
