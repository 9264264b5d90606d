"""K1: the slot-scheduled Felsenstein kernel.

Replaces phyml_tpu/ops/pallas_clv_slots.py:_slot_kernel (wrapper
uppass_site_lse_slots).  Each node's partial is consumed exactly once
(by its parent), so evaluating the heavier child subtree first
(Sethi-Ullman ordering) needs at most ceil(log2 n_otu) + 1 live
partials.  The host builds, per topology, a schedule of steps

    (child0 id, child0 is tip, child0 slot,
     child1 id, child1 is tip, child1 slot, destination slot)

and the kernel walks it with n_slots partials per pattern column, in
shared memory (`csrc/clv_slots.cu`; its header gives the design and
what bounds it).  Each consumption is one per-class matvec
P(t_child) @ clv_child; each step rescales by an exact power of two.
The output is the variable-rate site log-likelihood; the caller folds
in +I.

`uppass_site_lse_slots` launches the kernel for CUDA tensors and runs
the plain PyTorch version `uppass_site_lse_slots_plain` for CPU
tensors.

K4, `uppass_site_lse_slots_stream`, replaces
phyml_tpu/ops/pallas_clv_slots.py:_slot_stream_kernel (wrapper
uppass_site_lse_slots_stream).  It computes K1's function; each
schedule step's two P-matrices and tip rows are staged into a
double-buffered shared-memory ring (`csrc/clv_slots_stream.cu`), for
trees whose P-matrices no longer stay close to one SM
(likelihood.kernel_route).  Its plain version is K1's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from phyml_tpu_torch.ops import _build
from phyml_tpu_torch.ops.clv import LN2, pow2_rescale


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


def _launch_slots(fn_name, name, sched, tips, pmats, pi, logw, n_slots):
    """Check the operands and launch one of the slot kernels (K1, K4),
    which share a C signature; returns the site lse [P]."""
    _build.check_operands(name, ints=(sched,),
                          floats=(tips, pmats, pi, logw))
    n_otu, ns, P = tips.shape
    n_int = sched.shape[0]
    C = pmats.shape[1]
    if sched.shape != (n_int, 7) or \
            pmats.shape != (n_otu + n_int, C, ns, ns) or \
            pi.shape != (C, ns) or logw.shape != (C,):
        raise ValueError(f"{name}: inconsistent operand shapes")
    out = torch.empty(P, dtype=torch.float32, device=tips.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(tips.device):
        rc = getattr(_build.library(), fn_name)(
            ptr(sched), ptr(tips), ptr(pmats), ptr(pi), ptr(logw),
            ptr(out), n_int, n_slots, ns, C, P,
            _build.block_patterns(C), _build.stream_of(tips))
    _build.check(rc, name, ns)
    return out


def uppass_site_lse_slots(sched, tips, pmats, pi, logw, *, n_slots: int):
    """Variable-rate site log-likelihood [P] via K1 (same contract as
    uppass_site_lse_slots_plain)."""
    if tips.device.type == "cpu":
        return uppass_site_lse_slots_plain(sched, tips, pmats, pi, logw,
                                           n_slots=n_slots)
    out = _launch_slots("phyml_slot_site_lse", "uppass_site_lse_slots",
                        sched, tips, pmats, pi, logw, n_slots)
    uppass_site_lse_slots.launches += 1
    return out


def uppass_site_lse_slots_stream(sched, tips, pmats, pi, logw, *,
                                 n_slots: int):
    """Variable-rate site log-likelihood [P] via K4, the streamed slot
    kernel.  It computes K1's function, so its plain version is K1's,
    uppass_site_lse_slots_plain (same contract), which runs for CPU
    tensors."""
    if tips.device.type == "cpu":
        return uppass_site_lse_slots_plain(sched, tips, pmats, pi, logw,
                                           n_slots=n_slots)
    # the ring copies P-matrices in 16-byte pieces
    _build.check_aligned("uppass_site_lse_slots_stream", pmats)
    out = _launch_slots("phyml_slot_site_lse_stream",
                        "uppass_site_lse_slots_stream", sched, tips,
                        pmats, pi, logw, n_slots)
    uppass_site_lse_slots_stream.launches += 1
    return out


uppass_site_lse_slots.launches = 0
uppass_site_lse_slots_stream.launches = 0
