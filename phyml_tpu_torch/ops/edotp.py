"""K2: the fused up + outside + edge-dot-product kernel.

Replaces phyml_tpu/ops/pallas_edotp.py:_edotp_kernel (wrapper
edge_dotprods_pallas).  The branch-length optimizer consumes, for
every edge u, the eigen-basis dot products

    d[u]    = (V^T O_u) * (V^-1 C_u)        [C, ns, P]
    sc_d[u] = (sc_out[u] + sc[u]) * ln 2    [C, P]

(LikelihoodEngine.edge_dotprods_sys; reference Update_Eigen_Lr
lk.c:1038 + dLk lk.c:655).  One postorder sweep stores the rescaled
internal partials C_u, one reverse sweep builds the outside partials
O_u and writes d/sc_d per node (`csrc/edotp.cu`; its header gives the
design and what bounds it).  The root row is zeroed; the row of the
zero-length root child is meaningless and masked by the callers.

The kernel and the engine's scan path split d and sc_d differently
(power-of-two rescale against divide-by-max), so compare them through
LikelihoodEngine.edge_site_terms, never raw d.

`edge_dotprods` launches the kernel for CUDA tensors and runs the
plain PyTorch version `edge_dotprods_plain` for CPU tensors.

K5, `edge_dotprods_stream`, replaces
phyml_tpu/ops/pallas_edotp.py:_edotp_stream_kernel (wrapper
edge_dotprods_pallas_stream).  It computes K2's function; each step's
three P-matrices (child 0, child 1, parent) and tip rows are staged
into a double-buffered shared-memory ring (`csrc/edotp_stream.cu`),
for trees whose P-matrices no longer stay close to one SM
(likelihood.kernel_route).  Its plain version is K2's.
"""

from __future__ import annotations

import ctypes

import torch

from phyml_tpu_torch.ops import _build
from phyml_tpu_torch.ops.clv import LN2, pow2_rescale


def edge_dotprods_plain(child, tips, pmats, V, Vinv, pi):
    """Plain PyTorch version of the K2 kernel (any float dtype).

    child int [n_int, 2]; tips [n_otu, ns, P]; pmats
    [n_nodes, C, ns, ns]; V, Vinv [C, ns, ns]; pi [C, ns]
    -> (d [n_nodes, C, ns, P], sc_d [n_nodes, C, P]).
    """
    n_otu, ns, P = tips.shape
    n_nodes, C = pmats.shape[:2]
    n_int = n_nodes - n_otu
    rows = child.tolist()
    mv = lambda pm, x: torch.einsum("cxy,cyp->cxp", pm, x)
    clv = {}  # internal node -> (rescaled partial, log2 scale)

    def node_clv(u):
        return (tips[u].expand(C, ns, P), 0.0) if u < n_otu else clv[u]

    for i, (c0, c1) in enumerate(rows):
        x0, s0 = node_clv(c0)
        x1, s1 = node_clv(c1)
        x, e = pow2_rescale(mv(pmats[c0], x0) * mv(pmats[c1], x1))
        clv[n_otu + i] = (x, s0 + s1 + e)

    d = tips.new_zeros((n_nodes, C, ns, P))
    sc_d = tips.new_zeros((n_nodes, C, P))
    out = {}  # internal node -> (outside partial, log2 scale)
    for i in range(n_int - 1, -1, -1):  # root row first
        c0, c1 = rows[i]
        x0, s0 = node_clv(c0)
        x1, s1 = node_clv(c1)
        p0 = mv(pmats[c0], x0)
        p1 = mv(pmats[c1], x1)
        if i == n_int - 1:
            g, sg = pi[:, :, None], 0.0
        else:
            o_u, sg = out.pop(n_otu + i)
            g = torch.einsum("cwz,cwp->czp", pmats[n_otu + i], o_u)
        o0, e0 = pow2_rescale(g * p1)
        o1, e1 = pow2_rescale(g * p0)
        for cn, o, sco, x, sx in ((c0, o0, sg + s1 + e0, x0, s0),
                                  (c1, o1, sg + s0 + e1, x1, s1)):
            if cn >= n_otu:
                out[cn] = (o, sco)
            d[cn] = torch.einsum("czi,czp->cip", V, o) * mv(Vinv, x)
            sc_d[cn] = (sco + sx) * LN2
    return d, sc_d


def _launch_edotp(fn_name, name, child, tips, pmats, V, Vinv, pi):
    """Check the operands and launch one of the edge-dot-product
    kernels (K2, K5), which share a C signature; returns (d, sc_d)."""
    _build.check_operands(name, ints=(child,),
                          floats=(tips, pmats, V, Vinv, pi))
    n_otu, ns, P = tips.shape
    n_nodes, C = pmats.shape[:2]
    n_int = n_nodes - n_otu
    if child.shape != (n_int, 2) or pmats.shape[2:] != (ns, ns) or \
            V.shape != (C, ns, ns) or Vinv.shape != (C, ns, ns) or \
            pi.shape != (C, ns):
        raise ValueError(f"{name}: inconsistent operand shapes")
    tp = _build.block_patterns(C)
    Pw = -(-P // tp) * tp
    dev = tips.device
    f32 = dict(dtype=torch.float32, device=dev)
    d = torch.empty((n_nodes, C, ns, P), **f32)
    sc_d = torch.empty((n_nodes, C, P), **f32)
    ws = [torch.empty((n_int, C, ns, Pw), **f32),
          torch.empty((n_int, C, Pw), **f32),
          torch.empty((n_int, C, ns, Pw), **f32),
          torch.empty((n_int, C, Pw), **f32)]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        rc = getattr(_build.library(), fn_name)(
            ptr(child), ptr(tips), ptr(pmats), ptr(V), ptr(Vinv),
            ptr(pi), ptr(d), ptr(sc_d), *map(ptr, ws), n_otu, n_int, ns,
            C, P, Pw, tp, _build.stream_of(tips))
    _build.check(rc, name, ns)
    return d, sc_d


def edge_dotprods(child, tips, pmats, V, Vinv, pi):
    """(d, sc_d) via K2 (same contract as edge_dotprods_plain)."""
    if tips.device.type == "cpu":
        return edge_dotprods_plain(child, tips, pmats, V, Vinv, pi)
    out = _launch_edotp("phyml_edge_dotprods", "edge_dotprods", child,
                        tips, pmats, V, Vinv, pi)
    edge_dotprods.launches += 1
    return out


def edge_dotprods_stream(child, tips, pmats, V, Vinv, pi):
    """(d, sc_d) via K5, the streamed edge-dot-product kernel.  It
    computes K2's function, so its plain version is K2's,
    edge_dotprods_plain (same contract), which runs for CPU
    tensors."""
    if tips.device.type == "cpu":
        return edge_dotprods_plain(child, tips, pmats, V, Vinv, pi)
    # the ring copies P-matrices, V and V^-1 in 16-byte pieces
    _build.check_aligned("edge_dotprods_stream", pmats, V, Vinv)
    out = _launch_edotp("phyml_edge_dotprods_stream",
                        "edge_dotprods_stream", child, tips, pmats, V,
                        Vinv, pi)
    edge_dotprods_stream.launches += 1
    return out


edge_dotprods.launches = 0
edge_dotprods_stream.launches = 0
