"""K3: the child-table Felsenstein kernel, batched over parameter sets.

Replaces phyml_tpu/ops/pallas_clv.py:_uppass_kernel (wrapper
uppass_site_lse) and the vmap of it in the parameter line search.
Per site pattern it computes

    lse[p] = logsumexp_c( log w_c + sc_root[c, p]
                          + log sum_x pi[c, x] * clv_root[c, x, p] )

the variable-rate part of the site log-likelihood (the caller folds in
+I), walking the postorder child table: each internal node combines
its children's pushed partials, rescales by an exact power of two,
and pushes the result through its own edge's P-matrix; the root row
is not pushed.  The CUDA kernel (`csrc/clv.cu`) walks the same tree
through the Sethi-Ullman slot schedule of K1 and K4, with its partials
in shared memory, so the wrapper allocates only the output; see the
kernel's header for the design and what bounds it.

`uppass_site_lse` launches the kernel for CUDA tensors and runs the
plain PyTorch version `uppass_site_lse_plain` for CPU tensors.  The
kernel is built for the rungs of the state-count ladder
(`_build.LADDER`); operands of another state count are padded to the
next rung (tips, P-matrices and pi, a copy of each per launch), which
leaves the output unchanged.  Past the top rung the launcher runs K3's
big body (`csrc/big_slots.cu`, the design in `csrc/big.cuh`, its shape
`big_geometry`), ns padded to a multiple of 16 the same way.
"""

from __future__ import annotations

import ctypes

import torch

from phyml_tpu_torch.ops import _build
from phyml_tpu_torch.utils import trace

LN2 = 0.6931471805599453


def pow2_rescale(x: torch.Tensor):
    """Scale each [.., ns, P] column so its max lies in [1, 2), by an
    exact power of two read from the float exponent bits of the max
    (floored at the dtype's smallest normal).  Returns (scaled x, log2
    scale [.., P]) — the kernels' rescale
    (phyml_tpu/ops/pallas_clv_slots.py:189-196), valid in float32 and
    float64."""
    tiny = torch.finfo(x.dtype).tiny
    m = torch.clamp(torch.amax(x, dim=-2), min=tiny)
    if x.dtype == torch.float32:
        ib, shift, bias, mask = torch.int32, 23, 127, 0xFF
    else:
        ib, shift, bias, mask = torch.int64, 52, 1023, 0x7FF
    e = (m.view(ib) >> shift) & mask
    factor = ((2 * bias - e) << shift).view(x.dtype)
    return x * factor[..., None, :], (e - bias).to(x.dtype)


def uppass_site_lse_plain(child, tips, pmats, pi, logw):
    """Plain PyTorch version of the K3 kernel (any float dtype).

    child int [n_int, 2]; tips [n_otu, ns, P]; pmats
    [B, n_nodes, C, ns, ns]; pi [B, C, ns]; logw [B, C] -> [B, P].
    With a child table per entry, child [B, n_int, 2], each entry walks
    its own tree, and pi [C, ns] / logw [C] may be one system for all.
    """
    if child.dim() == 3:
        B = pmats.shape[0]
        pi, logw = pi.expand(B, *pi.shape[-2:]), logw.expand(B, logw.shape[-1])
        return torch.cat([uppass_site_lse_plain(
            child[b], tips, pmats[b:b + 1], pi[b:b + 1], logw[b:b + 1])
            for b in range(B)])
    n_otu = tips.shape[0]
    tiny = torch.finfo(tips.dtype).tiny
    rows = child.tolist()
    pushed_of = {}  # internal node -> (pushed partial, log2 scale)

    def pushed(node):
        if node < n_otu:
            return torch.einsum("bcxy,yp->bcxp", pmats[:, node],
                                tips[node]), 0.0
        return pushed_of.pop(node)  # each partial is consumed once

    for i, (c0, c1) in enumerate(rows[:-1]):
        v0, s0 = pushed(c0)
        v1, s1 = pushed(c1)
        x, e = pow2_rescale(v0 * v1)
        u = n_otu + i
        pushed_of[u] = (torch.einsum("bcxy,bcyp->bcxp", pmats[:, u], x),
                        s0 + s1 + e)
    v0, s0 = pushed(rows[-1][0])
    v1, s1 = pushed(rows[-1][1])
    lroot = torch.clamp(torch.einsum("bcx,bcxp->bcp", pi, v0 * v1),
                        min=tiny)
    a = logw[..., None] + (s0 + s1) * LN2 + torch.log(lroot)
    return torch.logsumexp(a, dim=1)


def _check_shapes(name, child, sched, tips, pmats, pi, logw, n_slots):
    """Raise ValueError unless the operands of uppass_site_lse (with a
    leading batch axis, and a child table and schedule per entry or one
    for all) agree with each other and with n_slots slots."""
    n_otu, ns, _ = tips.shape
    B, n_nodes, C = pmats.shape[:3]
    n_int = n_nodes - n_otu
    lead = (B,) if child.dim() == 3 else ()
    if child.shape != lead + (n_int, 2) or pmats.shape[3:] != (ns, ns) \
            or pi.shape[-2:] != (C, ns) or logw.shape[-1:] != (C,) \
            or pi.shape[:-2] != logw.shape[:-1] \
            or pi.shape[:-2] not in ((B,), () if lead else (B,)):
        raise ValueError(f"{name}: inconsistent operand shapes")
    if sched.shape != lead + (n_int, 7):
        raise ValueError(f"{name}: the schedule has shape "
                         f"{tuple(sched.shape)}, expected "
                         f"{lead + (n_int, 7)}")
    check_schedule(name, sched.reshape(-1, 7), n_otu, n_nodes, n_slots)


def check_schedule(name, sched, n_otu, n_nodes, n_slots):
    """Raise ValueError unless n_slots lies in [1, n_int] and, for a
    CPU schedule, every row fits n_slots slots and the tree's nodes:
    the kernels' contract (K1, K3, K4), which they check on the card
    once per block, trapping on a row that does not fit (a device-side
    assert: the next synchronization raises)."""
    n_int = n_nodes - n_otu
    if not 1 <= n_slots <= n_int:
        raise ValueError(f"{name}: n_slots={n_slots} outside [1, {n_int}]")
    if sched.device.type == "cpu":
        s = sched.to(torch.int64)
        ids, tip = s[:, [0, 3]], s[:, [1, 4]] != 0
        outside = lambda v, hi: (v < 0) | (v >= hi)
        bad = outside(ids, torch.where(tip, n_otu, n_nodes - 1)) \
            | (~tip & outside(s[:, [2, 5]], n_slots))
        if bool(bad.any()) or bool(outside(s[:, 6], n_slots).any()):
            raise ValueError(f"{name}: the schedule does not fit "
                             f"{n_slots} slots and {n_nodes} nodes")


def uppass_site_lse(child, tips, pmats, pi, logw, *, sched, n_slots: int):
    """Variable-rate site log-likelihood via K3.

    pmats [n_nodes, C, ns, ns] with pi [C, ns], logw [C] -> [P]; or a
    batch of parameter sets, pmats [B, n_nodes, C, ns, ns] with
    pi [B, C, ns], logw [B, C] -> [B, P] (one launch).  child is the
    postorder child table [n_int, 2], which the plain version walks;
    sched int32 [n_int, 7] and n_slots are its slot schedule
    (ops/clv_slots.py:build_slot_schedule), which the kernel walks.

    A stack of trees, one per entry (the rapid bootstrap's replicates):
    child [B, n_int, 2] and sched [B, n_int, 7], each entry's own, with
    n_slots the largest of their slot counts; pi [C, ns] and logw [C]
    may then be one system for every entry.  Still one launch.
    """
    name = "uppass_site_lse"
    batched = pmats.dim() == 5
    if not batched:
        pmats, pi, logw = pmats[None], pi[None], logw[None]
    _check_shapes(name, child, sched, tips, pmats, pi, logw, n_slots)
    per_entry, shared = child.dim() == 3, pi.dim() == 2
    if tips.device.type == "cpu":
        out = uppass_site_lse_plain(child, tips, pmats, pi, logw)
        return out if batched else out[0]
    _build.check_operands(name, ints=(sched,),
                          floats=(tips, pmats, pi, logw))
    NS = _build.rung(tips.shape[1])
    tips = _build.pad_states(tips, NS, (1,))
    pmats = _build.pad_states(pmats, NS, (3, 4))
    pi = _build.pad_states(pi, NS, (pi.dim() - 1,))
    # the ring copies P-matrices in 16-byte pieces
    _build.check_aligned(name, pmats)
    n_otu, ns, P = tips.shape
    B, n_nodes, C = pmats.shape[:3]
    out = torch.empty((B, P), dtype=torch.float32, device=tips.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(tips.device):
        rc = _build.library().phyml_batched_uppass(
            ptr(sched), ptr(tips), ptr(pmats), ptr(pi), ptr(logw),
            ptr(out), n_otu, n_nodes - n_otu, n_slots, ns, C, P, B,
            int(per_entry), int(shared), _build.stream_of(tips))
    _build.check(rc, name, ns, C=C, n_slots=n_slots, P=P, B=B)
    # by batch size B of one schedule (the optimizer's probes are B = 1
    # and 2, its line-search grid 13 per free scalar), or by the number
    # of stacked trees with a schedule each (the rapid bootstrap's)
    trace.count("launch.K3")
    trace.count(f"launch.K3.trees.{B}" if per_entry
                else f"launch.K3.batch.{B}")
    return out if batched else out[0]


def big_geometry(ns: int, C: int, P: int, n_slots: int) -> dict:
    """Launch shape of the big K3/K4 body past the ladder
    (csrc/big_slots.cu), at NS = rung(ns): a block on one tile of T
    patterns (`_build.big_pass_tile`: 32 where the block then leaves two
    blocks an SM, else 16), one warp per `_build.BIG_WARP_COLS` of them
    and one that stages the ring, one block per tile and class (and per
    batch entry for K3), the C blocks of a tile one cluster (`cluster`;
    past `_build.BIG_CLUSTER_MAX` classes one block per tile walks them
    in turn, cluster 1); its shared memory
    (`_build.big_pass_smem`) is the mbarriers, the ring, the n_slots
    slots, two tip tiles and C x T class terms; a warp's share is its
    columns of the slots and tip tiles."""
    NS = _build.rung(ns)
    T = _build.big_pass_tile(NS, C, n_slots)
    W = T // _build.BIG_WARP_COLS + 1
    ld = NS + _build.BIG_PAD_N
    warp = 4 * _build.BIG_WARP_COLS * (n_slots * (ld + 1) + 2 * ld)
    cluster = C if C <= _build.BIG_CLUSTER_MAX else 1
    return dict(tile=T, blocks=-(-P // T) * cluster, cluster=cluster,
                warps_per_block=W, warp_smem_bytes=warp,
                block_smem_bytes=_build.big_pass_smem(NS, C, n_slots, T))


def blocks_per_sm(ns: int, C: int, n_slots: int) -> int:
    """Blocks of K3 (32 * C threads each, `big_geometry`'s warps past
    the ladder) one SM of the current
    device holds at the rung of ns, as the CUDA runtime grants them."""
    blocks = ctypes.c_int(0)
    NS = _build.rung(ns)
    rc = _build.library().phyml_batched_uppass_occupancy(
        NS, C, n_slots, ctypes.byref(blocks))
    _build.check(rc, "uppass_site_lse blocks_per_sm", NS)
    return blocks.value
