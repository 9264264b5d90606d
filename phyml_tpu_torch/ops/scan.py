"""K7: the engine's scan passes, one launch a pass.

`LikelihoodEngine._up_pass` and `_down_pass` (ops/likelihood.py) feed
the NNI scorer, the rapid bootstrap's stacked scorer, the ancestral
states, the cross-validation and the scan path's reference entries.
Unmasked, on CUDA float32 tensors, each pass is one launch of K7
(`csrc/scan.cu`; its header gives the design and the bound):

    up_pass(child, tips, pmats)               -> pup, clv, sc
    down_pass(child, pmats, pup, sc, pi)      -> out, sc_out

with the loops' contract: divide-by-max rescaling, natural-log scales,
pup, clv, out [n_nodes, C, ns, P], sc, sc_out [n_nodes, C, P], the
root's rows of out and sc_out zero; a stack of R trees (child [R, n_int,
2], pmats [R, n_nodes, C, ns, ns]) adds a leading R axis to each, one
launch for all.  The outputs are allocated empty (the kernel writes
every row) with rows `padded(P)` apart, P rounded up to 32, and returned
as views of their first P patterns: each tile's rows are then whole
sectors, read and written 16 bytes a lane.

K7 replaces no TPU kernel: the JAX package runs these passes in jnp.
Its plain version is the engine's loop, which runs for CPU tensors,
float64 and a prune mask (the SPR scorer's masked form); the route is
chosen by those alone (LikelihoodEngine._scan_kernel).  K7 has a block
up to 2,048 states; past them its launch is refused
(NotImplementedError).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from phyml_tpu_torch.ops import _build
from phyml_tpu_torch.utils import trace


def geometry(ns: int, down: bool = False) -> dict:
    """K7's launch geometry at ns states, as the kernel library computes
    it (csrc/scan.cu: scan_geometry): the padded state count NS (the
    rung of the ladder up to 32 states, else ns rounded up to 4; the
    P-matrices' rows lie NS apart), the block's tile of patterns, its
    threads, its shared memory (0 where no block fits) and whether the
    up product stages its matrix in shared memory."""
    res = (ctypes.c_int * 5)()
    rc = _build.library().phyml_scan_geometry(
        ns, int(down), ctypes.cast(res, ctypes.c_void_p))
    _build.check(rc, "phyml_scan_geometry", ns)
    return dict(NS=res[0], tile=res[1], threads=res[2], smem_bytes=res[3],
                staged=bool(res[4]))


def check_child_table(name: str, child, n_otu: int) -> None:
    """The walk's contract on a host child table (each of a stack), which
    each block also checks and traps on: row i's children lie in
    [0, n_otu + i) and differ."""
    rows = np.asarray(torch.as_tensor(child), dtype=np.int64)
    limit = n_otu + np.arange(rows.shape[-2])[:, None]
    if ((rows < 0) | (rows >= limit)).any() or \
            (rows[..., 0] == rows[..., 1]).any():
        raise ValueError(f"{name}: the child table is not a postorder of "
                         f"{n_otu} tips (a child outside [0, n_otu + i) in "
                         "row i, or two equal children)")


def _shapes(name, child, pmats, n_otu, ns, P, *parts):
    """(lead, n_int, C) of a launch; ValueError where the operands'
    shapes disagree: child [*lead, n_int, 2], pmats [*lead, n_otu +
    n_int, C, ns, ns] with at most one leading axis, and each of `parts`
    (label, tensor, the shape it must have given (lead, n_nodes, C))."""
    lead = tuple(child.shape[:-2])
    n_int = child.shape[-2] if child.dim() >= 2 else 0
    C = pmats.shape[-3] if pmats.dim() >= 3 else 0
    n_nodes = n_otu + n_int
    bad = []
    if len(lead) > 1 or n_int < 1 or child.shape[-1:] != (2,):
        bad.append(f"child {tuple(child.shape)}")
    if tuple(pmats.shape) != lead + (n_nodes, C, ns, ns):
        bad.append(f"pmats {tuple(pmats.shape)}")
    for label, t, want in parts:
        if tuple(t.shape) != want(lead, n_nodes, C):
            bad.append(f"{label} {tuple(t.shape)}")
    if bad:
        raise ValueError(f"{name}: operand shapes do not match {n_otu} "
                         f"tips of {ns} states and {P} patterns: "
                         + ", ".join(bad))
    return lead, n_int, C


def _rows(name, pmats, NS):
    """The P-matrices with rows NS (`geometry`) apart, as the kernel reads
    them (16 bytes at a time): a copy where ns is not NS, padded with
    zero rows and columns."""
    pmats = _build.pad_states(pmats, NS, (pmats.dim() - 2, pmats.dim() - 1))
    _build.check_aligned(name, pmats)
    return pmats


def padded(P: int) -> int:
    """Pw, the row stride of every tensor K7 writes: P rounded up to 32
    patterns (a tile's rows are whole sectors; the columns past P hold
    copies of the last pattern's values)."""
    return -(-P // 32) * 32


def _empty(shape, P, device):
    """A float32 tensor of `shape` stored with rows padded(P) apart: the
    view of the first P patterns of a contiguous [..., Pw] tensor."""
    full = torch.empty(tuple(shape[:-1]) + (padded(P),), dtype=torch.float32,
                       device=device)
    return full[..., :P]


def _check_padded(name, t):
    """K7's down pass reads the up pass's pup and sc as the up pass wrote
    them: a contiguous pattern axis, rows padded(P) apart."""
    want = torch.empty(tuple(t.shape[:-1]) + (padded(t.shape[-1]),),
                       device="meta").stride()
    if t.stride() != want:
        raise ValueError(f"{name}: pup and sc must be the up pass's, with a "
                         f"contiguous pattern axis and rows {padded(t.shape[-1])}"
                         f" floats apart; got strides {t.stride()}")


def _on_cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the operands must lie on a CUDA device, "
                         f"got {t.device}")


def _launch(name, fn_name, child, floats, outs, n_otu, n_int, ns, C, P,
            R, geo):
    """Check the child table (int32, on the float operands' device, which
    the callers checked), launch, count the launch (and by R for a stack
    of trees)."""
    _build.check_operands(name, ints=(child,), floats=floats[:1])
    dev = floats[0].device
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        rc = getattr(_build.library(), fn_name)(
            *map(ptr, (child,) + floats + outs), n_otu, n_int, ns, C, P,
            padded(P), R, _build.stream_of(floats[0]))
    _build.check(rc, name, ns, C=C, P=P, trees=R,
                 block_smem_bytes=geo["smem_bytes"] or "none fits")
    trace.count("launch.K7")
    if child.dim() == 3:
        trace.count(f"launch.K7.trees.{R}")


def up_pass(child, tips, pmats):
    """K7's up pass: (pup, clv, sc) of `_up_pass`'s loop in one launch,
    each stored with rows padded(P) apart.  child int32 [*lead, n_int, 2]
    (the postorder; on the card, or on the host, where it is checked
    first), tips [n_otu, ns, P], pmats [*lead, n_nodes, C, ns, ns]."""
    n_otu, ns, P = tips.shape
    lead, n_int, C = _shapes("scan.up_pass", child, pmats, n_otu, ns, P)
    if child.device.type == "cpu":
        check_child_table("scan.up_pass", child, n_otu)
        child = child.to(tips.device)
    _build.check_operands("scan.up_pass", floats=(tips, pmats))
    _on_cuda("scan.up_pass", tips)
    geo = geometry(ns)
    pmats = _rows("scan.up_pass", pmats, geo["NS"])
    n_nodes = n_otu + n_int
    pup = _empty(lead + (n_nodes, C, ns, P), P, tips.device)
    clv = _empty(pup.shape, P, tips.device)
    sc = _empty(lead + (n_nodes, C, P), P, tips.device)
    _launch("scan.up_pass", "phyml_scan_up", child, (tips, pmats),
            (pup, clv, sc), n_otu, n_int, ns, C, P, lead[0] if lead else 1,
            geo)
    return pup, clv, sc


def down_pass(child, pmats, pup, sc, pi):
    """K7's down pass: (out, sc_out) of `_down_pass`'s loop in one launch,
    stored as up_pass stores; pup and sc the up pass's, pi [C, ns]."""
    ns, P = pup.shape[-2:]
    n_otu = pup.shape[-4] - child.shape[-2]
    lead, n_int, C = _shapes(
        "scan.down_pass", child, pmats, n_otu, ns, P,
        ("pup", pup, lambda ld, n, c: ld + (n, c, ns, P)),
        ("sc", sc, lambda ld, n, c: ld + (n, c, P)),
        ("pi", pi, lambda ld, n, c: (c, ns)))
    if child.device.type == "cpu":
        check_child_table("scan.down_pass", child, n_otu)
        child = child.to(pup.device)
    _build.check_operands("scan.down_pass", floats=(pmats, pi))
    for t in (pup, sc):
        if t.dtype != torch.float32:
            raise ValueError(f"scan.down_pass: pup and sc must be float32, "
                             f"got {t.dtype}")
        _check_padded("scan.down_pass", t)
    _on_cuda("scan.down_pass", pup)
    geo = geometry(ns, down=True)
    pmats = _rows("scan.down_pass", pmats, geo["NS"])
    out = _empty(pup.shape, P, pup.device)
    sc_out = _empty(sc.shape, P, pup.device)
    _launch("scan.down_pass", "phyml_scan_down", child, (pmats, pi, pup, sc),
            (out, sc_out), n_otu, n_int, ns, C, P, lead[0] if lead else 1,
            geo)
    return out, sc_out
