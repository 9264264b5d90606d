"""Work counts and peaks: the operations and bytes a kernel call needs,
counted from its shapes, and the least time one H100 could take for it.

`pruning_flops` and `edotp_flops` are frozen copies of chip_smoke.py's.
Bytes count every input once and every output once, whatever a kernel
reads again (its workspace is not counted).  The peaks are NVIDIA's
published H100 SXM figures at the full 700 W: 67 TFLOP/s in float32
outside the tensor cores and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def pruning_flops(n_otu, C, ns, P, B=1):
    """Multiply-adds of one Felsenstein pass (K1, K3, K4): every node
    but the root pushed through its P-matrix once (2*ns^2 FLOPs per
    class and pattern), and one ns-product per internal node."""
    n_nodes, n_int = 2 * n_otu - 1, n_otu - 1
    return B * C * P * (2 * ns * ns * (n_nodes - 1) + ns * n_int)


def edotp_flops(n_otu, C, ns, P):
    """Multiply-adds the edge dot products need (K2, K5): the up sweep's
    pushes, the outside sweep's parent matvecs, and V^T O and V^-1 C
    for every non-root edge (2*ns^2 FLOPs each per class and pattern),
    plus the elementwise products.  A kernel that recomputes pushed
    partials instead of storing them does more."""
    n_nodes, n_int = 2 * n_otu - 1, n_otu - 1
    matvecs = (n_nodes - 1) + (n_int - 1) + 2 * (n_nodes - 1)
    return C * P * (2 * ns * ns * matvecs + ns * (n_int + 2 * n_int
                                                  + n_nodes - 1))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def least_seconds(flops, nbytes_) -> float:
    """The larger of the operations over the FP32 peak and the bytes
    over the HBM peak."""
    return max(flops / PEAK_FLOPS, nbytes_ / PEAK_BYTES)


def slot_pass(args, kwargs, out):
    """(FLOPs, bytes) of a one-system pass through the slot kernels:
    (sched, tips, pmats, pi, logw) -> out [P].  The tips may be padded
    past P columns; they are counted at P."""
    sched, tips, pmats, pi, logw = args[:5]
    n_otu, ns, P = tips.shape[0], pmats.shape[-1], out.shape[-1]
    C = pmats.shape[-3]
    return (pruning_flops(n_otu, C, ns, P),
            nbytes(sched, pmats, pi, logw, out) + 4 * n_otu * ns * P)


def batched_pass(args, kwargs, out):
    """(FLOPs, bytes) of K3's pass: (child, tips, pmats, pi, logw,
    sched=) with pmats [n_nodes, C, ns, ns] or [B, n_nodes, C, ns, ns]
    -> out [P] or [B, P]."""
    child, tips, pmats, pi, logw = args[:5]
    sched = kwargs["sched"]
    B = pmats.shape[0] if pmats.dim() == 5 else 1
    n_otu, ns, P = tips.shape
    C = pmats.shape[-3]
    return (pruning_flops(n_otu, C, ns, P, B),
            nbytes(sched, tips, pmats, pi, logw, out))


def edge_pass(args, kwargs, out):
    """(FLOPs, bytes) of the edge dot products: (child, tips, pmats, V,
    Vinv, pi) -> (d, sc_d), one tree or a stack of R."""
    child, tips, pmats, V, Vinv, pi = args[:6]
    n_otu, ns, P = tips.shape
    C = pmats.shape[-3]
    R = pmats.shape[0] if pmats.dim() == 5 else 1
    return (R * edotp_flops(n_otu, C, ns, P),
            nbytes(child, tips, pmats, V, Vinv, pi, *out))
