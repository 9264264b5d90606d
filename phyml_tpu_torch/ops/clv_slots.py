"""K1 and K4: one Felsenstein pass over the slot schedule, for one
parameter set.

Replace phyml_tpu/ops/pallas_clv_slots.py:_slot_kernel (K1, wrapper
uppass_site_lse_slots) and _slot_stream_kernel (K4, wrapper
uppass_site_lse_slots_stream).  Each node's partial is consumed exactly
once (by its parent), so evaluating the heavier child subtree first
(Sethi-Ullman ordering) needs at most ceil(log2 n_otu) + 1 live
partials.  The host builds, per topology, a schedule of steps

    (child0 id, child0 is tip, child0 slot,
     child1 id, child1 is tip, child1 slot, destination slot)

and the kernels walk it with the schedule's own n_slots partials per
pattern column, in shared memory.  Each consumption is one per-class
matvec P(t_child) @ clv_child; each step rescales by an exact power of
two.  The output is the variable-rate site log-likelihood; the caller
folds in +I.

Both kernels run one body (`csrc/slots.cuh`; its header gives the
design and what bounds it): a warp per (pattern tile of TILE patterns,
rate class), the class warps of a tile in one block that meets at a
barrier only at the root, register tiles, tip rows copied ahead of
their step in a per-warp cp.async ring.  K1 holds its
class's P-matrices for the whole tree in shared memory; K4 streams each
step's two through the ring, for trees whose matrices do not fit
(likelihood.kernel_route).  Each keeps its own name and launch counter;
both take the plain version `uppass_site_lse_slots_plain`, which the
wrappers run for CPU tensors.  The kernels read tips whose rows are
padded to the tile (`padded_tips`), so that tip rows are copied in
16-byte pieces: the engine holds its tips so, and the wrappers pad
other tips themselves (a copy).  `geometry` gives the launch shape and
shared memory the body computes, `blocks_per_sm` the runtime's
occupancy.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from phyml_tpu_torch.ops import _build
from phyml_tpu_torch.ops.clv import LN2, check_schedule, pow2_rescale


def build_slot_schedule(n_otu: int, child: np.ndarray):
    """Per-topology kernel schedule with Sethi-Ullman slot bounds.

    child: postorder [n_int, 2] (RootedView layout; the last row is
    the root).  Returns (sched int32 [n_int, 7], n_slots) where
    sched[i] = (c0_id, c0_is_tip, c0_slot, c1_id, c1_is_tip, c1_slot,
    dst_slot); steps are emitted in a re-ordered postorder (heavier
    subtree first) and the LAST step computes the root's combined
    partial into its dst slot.
    """
    child = np.asarray(child)
    n_int = child.shape[0]
    n_nodes = n_otu + n_int
    root = n_nodes - 1

    kids = {n_otu + i: (int(child[i, 0]), int(child[i, 1]))
            for i in range(n_int)}

    # Sethi-Ullman register need per node
    need = np.ones(n_nodes, dtype=np.int64)
    for i in range(n_int):
        u = n_otu + i
        a, b = kids[u]
        na, nb = need[a], need[b]
        need[u] = max(na, nb) if na != nb else na + 1

    steps = []
    slot_of: dict[int, int] = {}
    free: list[int] = []
    n_slots = 0

    def alloc() -> int:
        nonlocal n_slots
        if free:
            return free.pop()
        n_slots += 1
        return n_slots - 1

    def emit(u: int):
        """Iterative heavy-child-first postorder with slot reuse."""
        stack = [(u, False)]
        while stack:
            v, expanded = stack.pop()
            if v < n_otu:
                continue
            a, b = kids[v]
            if not expanded:
                stack.append((v, True))
                # heavier child first minimizes the live set
                first, second = (a, b) if need[a] >= need[b] else (b, a)
                stack.append((second, False))
                stack.append((first, False))
                continue
            row = []
            for c in (a, b):
                if c < n_otu:
                    row += [c, 1, 0]
                else:
                    s = slot_of.pop(c)
                    free.append(s)
                    row += [c, 0, s]
            dst = alloc()
            slot_of[v] = dst
            steps.append(row + [dst])

    emit(root)
    assert len(steps) == n_int
    return np.asarray(steps, dtype=np.int32), n_slots


def uppass_site_lse_slots_plain(sched, tips, pmats, pi, logw, *,
                                n_slots: int):
    """Plain PyTorch version of the K1 kernel (any float dtype).

    sched int [n_int, 7] from build_slot_schedule; tips [n_otu, ns, P];
    pmats [n_nodes, C, ns, ns]; pi [C, ns]; logw [C] -> [P].
    """
    _, ns, P = tips.shape
    C = pmats.shape[1]
    tiny = torch.finfo(tips.dtype).tiny
    slots = tips.new_zeros((n_slots, C, ns, P))
    scales = tips.new_zeros((n_slots, C, P))

    def pushed(cid, is_tip, slot):
        if is_tip:
            clv, sc = tips[cid].expand(C, ns, P), 0.0
        else:
            clv, sc = slots[slot], scales[slot]
        return torch.einsum("cxy,cyp->cxp", pmats[cid], clv), sc

    rows = sched.tolist()
    for c0, t0, s0, c1, t1, s1, dst in rows:
        p0, sca = pushed(c0, t0, s0)
        p1, scb = pushed(c1, t1, s1)
        x, e = pow2_rescale(p0 * p1)
        slots[dst] = x
        scales[dst] = sca + scb + e
    root = rows[-1][6]
    lroot = torch.clamp(torch.einsum("cx,cxp->cp", pi, slots[root]),
                        min=tiny)
    a = logw[:, None] + scales[root] * LN2 + torch.log(lroot)
    return torch.logsumexp(a, dim=0)


# Patterns one warp covers at every state count (kSlotTile in
# csrc/slots.cuh)
TILE = 32
# Ring stages: tip rows (and K4's P-matrices) are copied two steps ahead
# (kSlotAhead + 1)
STAGES = 3
# Shared memory one block may use on Hopper (common.cuh kMaxSmem)
MAX_BLOCK_SMEM = 232448


def geometry(ns: int, C: int, P: int, n_otu: int, n_slots: int,
             resident: bool) -> dict:
    """Launch shape of K1 (resident=True) or K4, as csrc/slots.cuh
    computes it: the pattern tile, the grid (one block of C warps per
    tile, a warp per class), the dynamic shared memory of one warp
    (slot_warp_floats: its class's P-matrices of every child node (K1)
    or the ring of two per stage (K4), the tip ring and the slots) and
    of a block (C warps and C x tile class terms).  A launch whose
    block needs more than MAX_BLOCK_SMEM is refused."""
    T, S = TILE, STAGES
    n_nodes = 2 * n_otu - 1
    pm = (n_nodes - 1) * ns * ns if resident else 2 * S * ns * ns
    warp = 4 * (pm + 2 * S * ns * T + n_slots * (ns + 1) * T)
    return dict(tile=T, blocks=-(-P // T), warp_smem_bytes=warp,
                block_smem_bytes=C * (warp + 4 * T))


def _check(name, sched, tips, pmats, pi, logw, n_slots):
    n_otu, ns, _ = tips.shape
    n_int = sched.shape[0]
    C = pmats.shape[1]
    if sched.shape != (n_int, 7) or \
            pmats.shape != (n_otu + n_int, C, ns, ns) or \
            pi.shape != (C, ns) or logw.shape != (C,):
        raise ValueError(f"{name}: inconsistent operand shapes")
    check_schedule(name, sched, n_otu, n_otu + n_int, n_slots)


def _launch_slots(fn_name, name, sched, tips, pmats, pi, logw, n_slots):
    """Check the operands and launch one of the slot kernels (K1, K4),
    which share a C signature; returns the site lse [P].  Tips whose
    rows are not padded to the tile are padded first (slot_tips)."""
    _build.check_operands(name, ints=(sched,), floats=(pmats, pi, logw))
    if tips.device != pmats.device or tips.dtype != torch.float32:
        raise ValueError(f"{name}: tips must be a float32 tensor on "
                         f"{pmats.device}, got {tips.dtype} on {tips.device}")
    tips = slot_tips(tips)
    n_otu, ns, P = tips.shape
    ldt = tips.stride(1)
    # the P-matrices are copied in 16-byte pieces
    _build.check_aligned(name, pmats)
    n_int = sched.shape[0]
    C = pmats.shape[1]
    out = torch.empty(P, dtype=torch.float32, device=tips.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(tips.device):
        rc = getattr(_build.library(), fn_name)(
            ptr(sched), ptr(tips), ptr(pmats), ptr(pi), ptr(logw),
            ptr(out), n_otu, n_int, n_slots, ns, C, P, ldt,
            _build.stream_of(tips))
    _build.check(rc, name, ns)
    return out


def padded_tips(tips):
    """A view [n_otu, ns, P] of a copy of tips whose rows are padded with
    ones to a whole number of TILE patterns: the kernels copy tip rows
    in 16-byte pieces (P is odd at the bench shapes, so unpadded rows
    start anywhere)."""
    n_otu, ns, P = tips.shape
    store = tips.new_ones((n_otu, ns, -(-P // TILE) * TILE))
    store[..., :P] = tips
    return store[..., :P]


def slot_tips(tips):
    """tips itself where its rows are padded as the kernels read them
    (unit stride, rows a multiple of 4 floats apart and holding whole
    tiles, rows of a tip adjacent, 16-byte aligned), else padded_tips
    of it."""
    n_otu, ns, P = tips.shape
    ldt = tips.stride(1)
    if tips.stride(2) == 1 and ldt % 4 == 0 and ldt >= -(-P // TILE) * TILE \
            and tips.stride(0) == ns * ldt and tips.data_ptr() % 16 == 0:
        return tips
    return padded_tips(tips)


def uppass_site_lse_slots(sched, tips, pmats, pi, logw, *, n_slots: int):
    """Variable-rate site log-likelihood [P] via K1 (same contract as
    uppass_site_lse_slots_plain)."""
    name = "uppass_site_lse_slots"
    _check(name, sched, tips, pmats, pi, logw, n_slots)
    if tips.device.type == "cpu":
        return uppass_site_lse_slots_plain(sched, tips, pmats, pi, logw,
                                           n_slots=n_slots)
    out = _launch_slots("phyml_slot_site_lse", name, sched, tips, pmats,
                        pi, logw, n_slots)
    uppass_site_lse_slots.launches += 1
    return out


def uppass_site_lse_slots_stream(sched, tips, pmats, pi, logw, *,
                                 n_slots: int):
    """Variable-rate site log-likelihood [P] via K4, the streamed slot
    kernel.  It computes K1's function, so its plain version is K1's,
    uppass_site_lse_slots_plain (same contract), which runs for CPU
    tensors."""
    name = "uppass_site_lse_slots_stream"
    _check(name, sched, tips, pmats, pi, logw, n_slots)
    if tips.device.type == "cpu":
        return uppass_site_lse_slots_plain(sched, tips, pmats, pi, logw,
                                           n_slots=n_slots)
    out = _launch_slots("phyml_slot_site_lse_stream", name, sched, tips,
                        pmats, pi, logw, n_slots)
    uppass_site_lse_slots_stream.launches += 1
    return out


def blocks_per_sm(ns: int, C: int, n_otu: int, n_slots: int,
                  stream: bool) -> int:
    """Blocks of K1 (stream=False) or K4 (C warps each) one SM of the
    current device holds for an n_otu-taxon tree walked with n_slots
    slots, as the CUDA runtime grants them."""
    fn = "phyml_slot_site_lse_stream_occupancy" if stream \
        else "phyml_slot_site_lse_occupancy"
    blocks = ctypes.c_int(0)
    rc = getattr(_build.library(), fn)(ns, C, n_otu, n_slots,
                                       ctypes.byref(blocks))
    _build.check(rc, fn, ns)
    return blocks.value


uppass_site_lse_slots.launches = 0
uppass_site_lse_slots_stream.launches = 0
