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
is not pushed.  The CUDA kernel is `csrc/clv.cu`; see its header for
the design and what bounds it.

`uppass_site_lse` launches the kernel for CUDA tensors and runs the
plain PyTorch version `uppass_site_lse_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from phyml_tpu_torch.ops import _build

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
    """
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


def uppass_site_lse(child, tips, pmats, pi, logw):
    """Variable-rate site log-likelihood via K3.

    pmats [n_nodes, C, ns, ns] with pi [C, ns], logw [C] -> [P]; or a
    batch of parameter sets, pmats [B, n_nodes, C, ns, ns] with
    pi [B, C, ns], logw [B, C] -> [B, P] (one launch).
    """
    batched = pmats.dim() == 5
    if not batched:
        pmats, pi, logw = pmats[None], pi[None], logw[None]
    if tips.device.type == "cpu":
        out = uppass_site_lse_plain(child, tips, pmats, pi, logw)
        return out if batched else out[0]
    name = "uppass_site_lse"
    _build.check_operands(name, ints=(child,),
                          floats=(tips, pmats, pi, logw))
    n_otu, ns, P = tips.shape
    B, n_nodes, C = pmats.shape[:3]
    n_int = n_nodes - n_otu
    if child.shape != (n_int, 2) or pmats.shape[3:] != (ns, ns) \
            or pi.shape != (B, C, ns) or logw.shape != (B, C):
        raise ValueError(f"{name}: inconsistent operand shapes")
    tp = _build.block_patterns(C)
    Pw = -(-P // tp) * tp
    dev = tips.device
    out = torch.empty((B, P), dtype=torch.float32, device=dev)
    ws_pup = torch.empty((B, n_int, C, ns, Pw), dtype=torch.float32,
                         device=dev)
    ws_sc = torch.empty((B, n_int, C, Pw), dtype=torch.float32,
                        device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        rc = _build.library().phyml_dense_site_lse(
            ptr(child), ptr(tips), ptr(pmats), ptr(pi), ptr(logw),
            ptr(out), ptr(ws_pup), ptr(ws_sc), n_otu, n_int, ns, C, P,
            Pw, B, tp, _build.stream_of(tips))
    _build.check(rc, name, ns)
    uppass_site_lse.launches += 1
    return out if batched else out[0]


uppass_site_lse.launches = 0
