"""K2 and K5: the fused up + outside + edge-dot-product kernels.

Replace phyml_tpu/ops/pallas_edotp.py:_edotp_kernel (K2, wrapper
edge_dotprods_pallas) and _edotp_stream_kernel (K5, wrapper
edge_dotprods_pallas_stream).  The branch-length optimizer consumes,
for every edge u, the eigen-basis dot products

    d[u]    = (V^T O_u) * (V^-1 C_u)        [C, ns, P]
    sc_d[u] = (sc_out[u] + sc[u]) * ln 2    [C, P]

(LikelihoodEngine.edge_dotprods_sys; reference Update_Eigen_Lr
lk.c:1038 + dLk lk.c:655).  One postorder sweep stores the rescaled
internal partials C_u, one reverse sweep builds the outside partials
O_u and writes d/sc_d per node.  The root row is zeroed; the row of the
zero-length root child is meaningless and masked by the callers.

Both kernels run one body (`csrc/edotp.cuh`; its header gives the
design and what bounds it): one block of one warp per pattern tile
(TILE patterns) and rate class, register tiles, each step's operands
(P-matrices, partials, outside partials) staged one step ahead in a
cp.async ring.  K2 (`edge_dotprods`) serves the resident route, K5
(`edge_dotprods_stream`) the streamed one (likelihood.kernel_route);
each keeps its own name and launch counter.  Both take the same plain
version, `edge_dotprods_plain`, which the wrappers run for CPU tensors.

The kernels and the engine's scan path split d and sc_d differently
(power-of-two rescale against divide-by-max), so compare them through
LikelihoodEngine.edge_site_terms, never raw d.

The kernels are built for the rungs of the state-count ladder
(`_build.LADDER`); operands of another state count are padded to the
next rung (tips, P-matrices, V, V^-1 and pi, a copy of each per launch,
each padded state a zero row and column or a zero), and d is returned
as the view of its first ns states: the padded states' rows of d are
zero.  Past the top rung both entries launch K5's big body
(`csrc/big_edotp.cu`, the design in `csrc/big_ffma.cuh`), whose state
count is a run-time argument: ns is padded to a multiple of 16
(`_build.rung`) the same way, a block holds `_build.big_edotp_warps`
warps of 16 patterns each on its tile and one that stages its ring.
"""

from __future__ import annotations

import ctypes

import torch

from phyml_tpu_torch.ops import _build
from phyml_tpu_torch.ops.clv import LN2, pow2_rescale
from phyml_tpu_torch.utils import trace


def edge_dotprods_plain(child, tips, pmats, V, Vinv, pi):
    """Plain PyTorch version of the K2 kernel (any float dtype).

    child int [n_int, 2]; tips [n_otu, ns, P]; pmats
    [n_nodes, C, ns, ns]; V, Vinv [C, ns, ns]; pi [C, ns]
    -> (d [n_nodes, C, ns, P], sc_d [n_nodes, C, P]).  A stack of R
    trees, child [R, n_int, 2] and pmats [R, n_nodes, C, ns, ns], gives
    d [R, n_nodes, C, ns, P] and sc_d [R, n_nodes, C, P], tree by tree.
    """
    if child.dim() == 3:
        outs = [edge_dotprods_plain(c, tips, pm, V, Vinv, pi)
                for c, pm in zip(child, pmats)]
        return tuple(torch.stack(x) for x in zip(*outs))
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


class _TileTable(dict):
    """Patterns per thread block by state count (kEdotpTile in
    csrc/edotp.cuh at the rungs, 16 a warp past them): the workspace's
    pattern axis is P rounded up to it.  Keyed by the ladder's rungs,
    and defined for every other state count through `_build.tile`."""

    def __missing__(self, ns):
        return _build.tile("edotp", ns)


TILE = _TileTable({NS: _build.tile("edotp", NS) for NS in _build.LADDER})
# Ring stages: each step's operands are copied one step ahead
# (kEdotpAhead + 1).
STAGES = 2


def geometry(ns: int, C: int, P: int) -> dict:
    """Launch geometry of K2 and K5 (one kernel body) at the rung NS of
    ns, as csrc/edotp.cuh computes it: the padded pattern width Pw, the
    grid (one block of one warp per pattern tile and class), the block's
    dynamic shared memory (kEdotpSmem) and the workspace floats per
    internal node.  Past the ladder, the big body's (csrc/big_edotp.cu):
    per tile and class a block of `_build.big_edotp_warps` warps on 16
    patterns each and one that stages the ring, V and V^-1 resident
    where `_build.big_edotp_resident`, its shared memory
    `_build.big_edotp_smem`; its workspace rows hold a node's two child
    products too (`workspace_rows`)."""
    NS = _build.rung(ns)
    T = TILE[NS]
    Pw = -(-P // T) * T
    if _build.is_big(NS):
        W = max(1, _build.big_edotp_warps(NS)) + 1
        smem = _build.big_edotp_smem(NS)
    else:
        W = 1
        smem = ((2 + 2 * STAGES) * NS * NS + 3 * STAGES * (NS + 1) * T
                + 2 * NS * T) * 4
    return dict(tile=T, Pw=Pw, blocks=Pw // T * C, threads=32 * W,
                warps_per_block=W, smem_bytes=smem,
                workspace_floats_per_node=C * workspace_rows(NS) * Pw)


def workspace_rows(NS: int) -> int:
    """Rows of a class's tile of a node in each of the two workspace
    tensors at the kernels' state count NS: the partial (or pushed
    outside partial) and its log2 scale, NS + 1; past the ladder also
    one of the node's two child products P_k x_k, which the big body's
    up sweep keeps for its down sweep (csrc/big_edotp.cu), 2 NS + 1."""
    return 2 * NS + 1 if _build.is_big(NS) else NS + 1


def check_child_table(name: str, child, n_otu: int) -> None:
    """The kernels' contract on the child table (each block checks it
    and traps): row i's children lie in [0, n_otu + i), the postorder
    both sweeps walk.  Checked here for CPU tables (each of a stack)."""
    rows = torch.as_tensor(child).to(torch.int64)
    limit = n_otu + torch.arange(rows.shape[-2])[:, None]
    if bool(((rows < 0) | (rows >= limit)).any()):
        raise ValueError(f"{name}: the child table is not a postorder of "
                         f"{n_otu} tips (a child outside [0, n_otu + i) "
                         "in row i)")


def _check_shapes(name, child, tips, pmats, V, Vinv, pi):
    n_otu, ns, P = tips.shape
    lead = tuple(child.shape[:-2])  # (R,) for a stack of trees
    n_nodes, C = pmats.shape[len(lead):len(lead) + 2]
    n_int = n_nodes - n_otu
    if n_int < 1 or len(lead) > 1 or child.shape != lead + (n_int, 2) or \
            pmats.shape != lead + (n_nodes, C, ns, ns) or \
            V.shape != (C, ns, ns) or Vinv.shape != (C, ns, ns) or \
            pi.shape != (C, ns):
        raise ValueError(f"{name}: inconsistent operand shapes")
    if child.device.type == "cpu":
        check_child_table(name, child, n_otu)


def _launch_edotp(name, kernel, fn_name, child, tips, pmats, V, Vinv,
                  pi):
    """Check the operands and launch one of the edge-dot-product
    kernels (K2, K5), which share a C signature, once for one tree or
    a stack of R trees (grid.z); count the launch as `kernel`'s, and by
    R for a stack.  Returns (d, sc_d)."""
    _build.check_operands(name, ints=(child,),
                          floats=(tips, pmats, V, Vinv, pi))
    ns_true = tips.shape[1]
    NS = _build.rung(ns_true)
    tips = _build.pad_states(tips, NS, (1,))
    pmats = _build.pad_states(pmats, NS, (pmats.dim() - 2, pmats.dim() - 1))
    V, Vinv = (_build.pad_states(m, NS, (1, 2)) for m in (V, Vinv))
    pi = _build.pad_states(pi, NS, (1,))
    # the tile products read the P-matrices in 16-byte pieces
    _build.check_aligned(name, pmats)
    n_otu, ns, P = tips.shape
    lead = tuple(child.shape[:-2])
    n_nodes, C = pmats.shape[len(lead):len(lead) + 2]
    n_int = n_nodes - n_otu
    Pw = geometry(ns, C, P)["Pw"]
    dev = tips.device
    f32 = dict(dtype=torch.float32, device=dev)
    d = torch.empty(lead + (n_nodes, C, ns, P), **f32)
    sc_d = torch.empty(lead + (n_nodes, C, P), **f32)
    # partials and pushed outside partials, row ns their log2 scales
    # (past the ladder then a child product each)
    ws = [torch.empty(lead + (n_int, C, workspace_rows(ns), Pw), **f32)
          for _ in range(2)]
    R = lead[0] if lead else 1
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        rc = getattr(_build.library(), fn_name)(
            ptr(child), ptr(tips), ptr(pmats), ptr(V), ptr(Vinv),
            ptr(pi), ptr(d), ptr(sc_d), *map(ptr, ws), n_otu, n_int, ns,
            C, P, Pw, R, _build.stream_of(tips))
    _build.check(rc, name, ns, C=C, n_otu=n_otu, P=P, trees=R,
                 block_smem_bytes=geometry(ns, C, P)["smem_bytes"])
    trace.count(f"launch.{kernel}")
    if lead:
        trace.count(f"launch.{kernel}.trees.{R}")
    return d[..., :ns_true, :], sc_d


def edge_dotprods(child, tips, pmats, V, Vinv, pi):
    """(d, sc_d) via K2 (same contract as edge_dotprods_plain, one
    launch for a stack of trees)."""
    _check_shapes("edge_dotprods", child, tips, pmats, V, Vinv, pi)
    if tips.device.type == "cpu":
        return edge_dotprods_plain(child, tips, pmats, V, Vinv, pi)
    return _launch_edotp("edge_dotprods", "K2", "phyml_edge_dotprods",
                         child, tips, pmats, V, Vinv, pi)


def edge_dotprods_stream(child, tips, pmats, V, Vinv, pi):
    """(d, sc_d) via K5, the streamed edge-dot-product kernel.  It
    computes K2's function, so its plain version is K2's,
    edge_dotprods_plain (same contract, one launch for a stack of
    trees), which runs for CPU tensors."""
    _check_shapes("edge_dotprods_stream", child, tips, pmats, V, Vinv, pi)
    if tips.device.type == "cpu":
        return edge_dotprods_plain(child, tips, pmats, V, Vinv, pi)
    return _launch_edotp("edge_dotprods_stream", "K5",
                         "phyml_edge_dotprods_stream", child, tips, pmats,
                         V, Vinv, pi)


def blocks_per_sm(ns: int, stream: bool) -> int:
    """Blocks (one warp each; `geometry`'s warps past the ladder) of K2
    (stream=False) or K5 one SM of the current device holds at the rung
    of ns, as the CUDA runtime grants them."""
    fn = "phyml_edge_dotprods_stream_occupancy" if stream \
        else "phyml_edge_dotprods_occupancy"
    blocks = ctypes.c_int(0)
    NS = _build.rung(ns)
    rc = getattr(_build.library(), fn)(NS, ctypes.byref(blocks))
    _build.check(rc, fn, NS)
    return blocks.value
