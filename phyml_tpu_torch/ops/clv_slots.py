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

The kernels are built for the rungs of the state-count ladder
(`_build.LADDER`); for another state count the wrappers pad the
operands to the next rung, a copy of each per launch: tips (zero rows),
P-matrices (a zero row and column) and pi (a zero).  Padded states add
nothing to any sum, so the output is unchanged.  Past the top rung both
entries launch K4's big body (`csrc/big_slots.cu`, the design in
`csrc/big.cuh`), whose state count is a run-time argument: the wrappers
pad ns to a multiple of 16 (`_build.rung`) the same way.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from phyml_tpu_torch.ops import _build
from phyml_tpu_torch.ops.clv import (
    LN2, big_geometry, check_schedule, pow2_rescale,
)
from phyml_tpu_torch.utils import trace


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


# Patterns the tips' rows are padded to: a multiple of every rung's
# warp tile (kSlotTile in csrc/slots.cuh: 32 up to 24 states, 16 above)
# and of the big bodies' (16)
TILE = 32
# Ring stages: tip rows (and K4's P-matrices) are copied two steps ahead
# (kSlotAhead + 1)
STAGES = 3
# Shared memory one block may use on Hopper (common.cuh kMaxSmem)
MAX_BLOCK_SMEM = _build.MAX_BLOCK_SMEM


def geometry(ns: int, C: int, P: int, n_otu: int, n_slots: int,
             resident: bool) -> dict:
    """Launch shape of K1 (resident=True) or K4 at the rung of ns, as
    csrc/slots.cuh computes it: the pattern tile, the grid (one block
    per tile of C warps, a warp per class), the dynamic shared memory
    of one warp
    (slot_warp_floats: its class's P-matrices of every child node (K1)
    or the ring of two per stage (K4), the tip ring and the slots) and
    of a block (its warps and C x tile class terms).  A launch whose
    block needs more than MAX_BLOCK_SMEM is refused.  Past the ladder
    both entries run K4's big body: `big_geometry` (a warp's share is
    its ring)."""
    NS = _build.rung(ns)
    if _build.is_big(NS):
        return big_geometry(ns, C, P, n_slots)
    T = _build.tile("slot", ns)
    n_nodes = 2 * n_otu - 1
    pm = (n_nodes - 1) * NS * NS if resident else 2 * STAGES * NS * NS
    warp = 4 * (pm + 2 * STAGES * NS * T + n_slots * (NS + 1) * T)
    return dict(tile=T, blocks=-(-P // T), warps_per_block=C,
                warp_smem_bytes=warp, block_smem_bytes=C * warp + 4 * C * T)


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
    rows are not padded to the tile are padded first (slot_tips), and
    operands of a state count between rungs are padded to the next
    rung."""
    _build.check_operands(name, ints=(sched,), floats=(pmats, pi, logw))
    if tips.device != pmats.device or tips.dtype != torch.float32:
        raise ValueError(f"{name}: tips must be a float32 tensor on "
                         f"{pmats.device}, got {tips.dtype} on {tips.device}")
    NS = _build.rung(tips.shape[1])
    tips = slot_tips(tips) if tips.shape[1] == NS else padded_tips(tips, NS)
    pmats = _build.pad_states(pmats, NS, (2, 3))
    pi = _build.pad_states(pi, NS, (1,))
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
    geo = geometry(ns, C, P, n_otu, n_slots,
                   resident=fn_name == "phyml_slot_site_lse")
    _build.check(rc, name, ns, C=C, n_otu=n_otu, n_slots=n_slots, P=P,
                 block_smem_bytes=geo["block_smem_bytes"])
    return out


def padded_tips(tips, NS: int | None = None):
    """A view [n_otu, ns, P] of a copy of tips whose rows are padded with
    ones to a whole number of TILE patterns: the kernels copy tip rows
    in 16-byte pieces (P is odd at the bench shapes, so unpadded rows
    start anywhere).  With NS (a rung above ns) the view has NS rows a
    tip, the added ones zero."""
    n_otu, ns, P = tips.shape
    NS = ns if NS is None else NS
    store = tips.new_ones((n_otu, NS, -(-P // TILE) * TILE))
    store[:, ns:] = 0.0
    store[:, :ns, :P] = tips
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
    trace.count("launch.K1")
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
    trace.count("launch.K4")
    return out


def blocks_per_sm(ns: int, C: int, n_otu: int, n_slots: int,
                  stream: bool) -> int:
    """Blocks of K1 (stream=False) or K4 (C warps each, `big_geometry`'s
    warps past the ladder) one SM of the current device holds
    for an n_otu-taxon tree walked with n_slots slots at the rung of ns,
    as the CUDA runtime grants them."""
    fn = "phyml_slot_site_lse_stream_occupancy" if stream \
        else "phyml_slot_site_lse_occupancy"
    blocks = ctypes.c_int(0)
    NS = _build.rung(ns)
    rc = getattr(_build.library(), fn)(NS, C, n_otu, n_slots,
                                       ctypes.byref(blocks))
    _build.check(rc, fn, NS)
    return blocks.value
