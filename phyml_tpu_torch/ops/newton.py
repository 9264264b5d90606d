"""K6: the edge-length Newton solve, one launch a solve.

Every branch-length Newton of the port runs here, through
`LikelihoodEngine.newton_solve(d, sc, aux, t, iters, mask=None)`: the
NNI scorer's four lengths a configuration (search/nni.py, 5
iterations), the SPR scorer's triple (search/spr.py, 6) and the
optimiser's all-edge round (optim/blen.py, 10, with a row mask).  Each
row of d [..., C, ns, P] (one edge length t [...], its scales sc [...,
C, P]) takes `iters` safeguarded Newton steps on its own likelihood
curve (LikelihoodEngine.edge_lnl_terms, then `_step`).

`solve_plain` is that loop in PyTorch, the plain version: it runs for
CPU tensors.  For CUDA tensors `solve` launches K6
(`csrc/edge_newton.cu`; its header gives the design and the bound) or
raises: one launch a solve, the step taken in the kernel.  On a sharded
engine each iteration's pattern sums have to meet over the ranks before
the step, so the same kernel body runs once an iteration through its
second entry (`edge_newton_sums`: the three row sums), the sums go
through `_sum_sites` and `_step` runs in PyTorch.

K6 replaces no TPU kernel: the JAX package runs the loop in jnp under
fori_loop.  Its arithmetic is the plain version's, float32 per pattern
and float64 pattern sums; the sums over states and classes are taken in
the same order, but exp and log are the card's, so lengths agree with
the plain version's to rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from phyml_tpu_torch.ops import _build
from phyml_tpu_torch.utils import trace

BL_MIN = 1e-8   # utilities.h:483
BL_MAX = 100.0  # utilities.h:484


def _step(t, d1, d2, t0, mask):
    """One safeguarded Newton step on the lengths t from the float64
    derivative sums d1, d2; rows where `mask` is False keep t0."""
    newton = t - d1 / torch.where(d2 < 0, d2, -1.0)
    # fall back to a multiplicative probe when curvature is useless;
    # clamp each step to a factor-of-3 move
    probe = torch.where(d1 > 0, t * 3.0, t / 3.0)
    t_new = torch.where(d2 < -1e-12, newton, probe)
    t_new = torch.minimum(torch.maximum(t_new, t / 3.0), t * 3.0)
    t_new = torch.clamp(t_new, BL_MIN, BL_MAX)
    if mask is not None:
        t_new = torch.where(mask, t_new, t0)
    # edge_lnl_terms accumulates in float64; keep t at t0's dtype
    return t_new.to(t0.dtype)


def solve_plain(engine, d, sc, aux, t, iters, mask=None):
    """Plain PyTorch version of K6 (any float dtype, any device): `iters`
    Newton steps on every row's length."""
    t0 = t
    for _ in range(iters):
        _, d1, d2 = engine.edge_lnl_terms(d, sc, aux, t)
        t = _step(t, d1, d2, t0, mask)
    return t


def check_shapes(name, d, sc, aux, t, mask=None):
    """The contract on shapes: d [*lead, C, ns, P] with at most two
    leading axes, sc [*lead, C, P], t [*lead], lam [C, ns], w [C], one
    pinv, inv_lk [P], weights [P] or [*lead[:k], 1, ..., 1, P] (one row
    for each group of trailing rows), mask broadcast to t."""
    if d.dim() < 3 or d.dim() > 5:
        raise ValueError(f"{name}: d must be [*lead, C, ns, P] with at "
                         f"most two leading axes, got {tuple(d.shape)}")
    lead, (C, ns, P) = tuple(d.shape[:-3]), d.shape[-3:]
    wts = aux["weights"]
    bad = []
    if tuple(sc.shape) != lead + (C, P):
        bad.append(f"sc {tuple(sc.shape)}")
    if tuple(t.shape) != lead:
        bad.append(f"t {tuple(t.shape)}")
    if tuple(aux["lam"].shape) != (C, ns):
        bad.append(f"lam {tuple(aux['lam'].shape)}")
    if aux["w"].numel() != C or aux["pinv"].numel() != 1:
        bad.append(f"w {tuple(aux['w'].shape)}, pinv "
                   f"{tuple(aux['pinv'].shape)}")
    if tuple(aux["inv_lk"].shape) != (P,):
        bad.append(f"inv_lk {tuple(aux['inv_lk'].shape)}")
    if _weight_groups(wts.shape, lead, P) is None:
        bad.append(f"weights {tuple(wts.shape)}")
    if mask is not None and not _broadcasts(mask.shape, t.shape):
        bad.append(f"mask {tuple(mask.shape)}")
    if bad:
        raise ValueError(f"{name}: shapes do not match d "
                         f"{tuple(d.shape)}: " + ", ".join(bad))


def _broadcasts(shape, to):
    """True when `shape` broadcasts to `to` unchanged."""
    try:
        return torch.broadcast_shapes(shape, to) == to
    except RuntimeError:
        return False


def _weight_groups(shape, lead, P):
    """G, the weight rows, when weights of `shape` give each group of
    rows / G consecutive rows one row: shape[:-1] is a prefix of lead
    followed by ones.  None when they do not."""
    shape = tuple(shape)
    if len(shape) < 1 or shape[-1] != P or len(shape) - 1 > len(lead):
        return None
    pre = shape[:-1]
    k = len(pre)
    while k and pre[k - 1] == 1:
        k -= 1
    if pre[:k] != lead[:k]:
        return None
    return math.prod(pre[:k])


def _lead2(x, n_lead):
    """The strides of x's first n_lead axes as two (a, b), the rows
    r = a * B + b; stride 0 for an absent axis."""
    s = x.stride()[:n_lead]
    return (0, 0) if n_lead == 0 else (s[0], 0) if n_lead == 1 else s


def _operands(name, d, sc, aux, t, mask, invar_ok):
    """Check K6's operands; returns the launch's pointers, strides and
    ints.  Float32 d, sc, t and model terms on one CUDA device, each
    pattern axis contiguous; weights are taken as float64."""
    check_shapes(name, d, sc, aux, t, mask)
    floats = (d, sc, t, aux["lam"], aux["w"], aux["pinv"], aux["inv_lk"],
              invar_ok)
    for x in floats:
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: d, sc, t and the model terms must "
                             f"be float32, got {x.dtype}")
    for label, x in (("d", d), ("sc", sc), ("inv_lk", aux["inv_lk"]),
                     ("invar_ok", invar_ok)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the pattern axis of {label} must be "
                             "contiguous")
    dev = d.device
    others = floats[1:] + (aux["weights"],) + \
        (() if mask is None else (mask,))
    if dev.type != "cuda" or any(x.device != dev for x in others):
        raise ValueError(f"{name}: the operands must lie on one CUDA "
                         f"device, got {sorted({str(x.device) for x in (d,) + others})}")
    lead, (C, ns, P) = tuple(d.shape[:-3]), d.shape[-3:]
    n = len(lead)
    rows = math.prod(lead)
    lead_b = lead[1] if n == 2 else 1
    wts = aux["weights"]
    G = _weight_groups(wts.shape, lead, P)
    wts = wts.to(torch.float64).reshape(G, P)
    if wts.stride(-1) != 1:
        wts = wts.contiguous()
    if mask is not None:
        mask = mask.to(torch.bool).expand(t.shape)
    lam, w = aux["lam"].contiguous(), aux["w"].contiguous()
    strides = (*_lead2(d, n), d.stride(-3), d.stride(-2), *_lead2(sc, n),
               sc.stride(-2), *_lead2(t, n),
               *(_lead2(mask, n) if mask is not None else (0, 0)),
               wts.stride(0) if G > 1 else 0)
    keep = (d, sc, t, mask, wts, lam, w, aux["pinv"], aux["inv_lk"],
            invar_ok)
    return keep, strides, (rows, lead_b, C, ns, P, rows // max(G, 1))


def _launch(name, fn_name, d, sc, aux, t, iters, mask, invar_ok, invar,
            out):
    keep, strides, (rows, lead_b, C, ns, P, group) = _operands(
        name, d, sc, aux, t, mask, invar_ok)
    ptr = lambda x: ctypes.c_void_p(0 if x is None else x.data_ptr())
    table = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(d.device):
        rc = getattr(_build.library(), fn_name)(
            *map(ptr, keep), ptr(out), ctypes.cast(table, ctypes.c_void_p),
            rows, lead_b, C, ns, P,
            iters, int(bool(invar)), group, _build.stream_of(d))
    _build.check(rc, name, ns, C=C, P=P, rows=rows)
    trace.count("launch.K6")


def edge_newton(d, sc, aux, t, iters, mask=None, *, invar_ok, invar):
    """K6: `iters` Newton steps on every row's length in one launch;
    returns the new lengths, a fresh float32 tensor of t's shape.
    invar_ok [P] marks the constant patterns (the engine's buffer) and
    `invar` says the model has +I."""
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    if out.numel():
        _launch("edge_newton", "phyml_edge_newton", d, sc, aux, t, iters,
                mask, invar_ok, invar, out)
    return out


def edge_newton_sums(d, sc, aux, t, *, invar_ok, invar):
    """K6's second entry: one iteration's three weighted pattern sums of
    each row (site lnL, d/dt, d2/dt2; float64, each t's shape), those
    of `edge_lnl_terms` before `_sum_sites`, and no step."""
    sums = torch.empty((3,) + tuple(t.shape), dtype=torch.float64,
                       device=t.device)
    if sums.numel():
        _launch("edge_newton_sums", "phyml_edge_newton_sums", d, sc, aux,
                t, 1, None, invar_ok, invar, sums)
    return sums.unbind(0)


def solve(engine, d, sc, aux, t, iters, mask=None):
    """`iters` Newton steps on every row's length: the plain version for
    CPU tensors, K6 for CUDA ones (one launch; on a sharded engine one
    launch of the sums entry an iteration, the step in PyTorch)."""
    check_shapes("newton_solve", d, sc, aux, t, mask)
    if d.device.type == "cpu":
        return solve_plain(engine, d, sc, aux, t, iters, mask)
    kw = dict(invar_ok=engine.invar_ok, invar=engine.model.invar)
    if engine._mesh is None:
        return edge_newton(d, sc, aux, t, iters, mask, **kw)
    t0 = t
    for _ in range(iters):
        _, d1, d2 = engine._sum_sites(*edge_newton_sums(d, sc, aux, t,
                                                        **kw))
        t = _step(t, d1, d2, t0, mask)
    return t


def geometry(rows: int, P: int, C: int, ns: int) -> dict:
    """K6's launch geometry on the current device for `rows` rows of P
    patterns: the cluster a row's patterns are split over (1: a block a
    row), the blocks the device holds at once in such clusters, its SMs
    and the rows an SM."""
    out = (ctypes.c_int * 3)()
    rc = _build.library().phyml_edge_newton_geometry(
        rows, P, C, ns, ctypes.cast(out, ctypes.c_void_p))
    _build.check(rc, "phyml_edge_newton_geometry", ns, C=C, P=P)
    return dict(cluster=out[0], slots=out[1], sms=out[2],
                rows_per_sm=rows / out[2])
