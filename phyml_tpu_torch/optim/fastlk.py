"""Normal approximation of the branch-length likelihood surface
(≙ the reference's --fastlk path: Hessian of lnL wrt branch lengths,
stats.c:2147 Hessian / stats.c:2522 gradient, consumed by
Lk_Normal_Approx lk.c:2521 — the Guindon-2010 speed trick for
PhyTime's MCMC).

Port of phyml_tpu/optim/fastlk.py.  The reference builds the Hessian by
central finite differences over edge lengths (stats.c:2147); phyml_tpu
takes one `jax.hessian`, and this port takes exact second derivatives
with torch.func through the scan path (LikelihoodEngine.
loglik_functional: the kernels have no backward pass) in float64 on
the engine's device: lnL0 and the gradient from one `grad_and_value`,
the Hessian as forward-over-reverse products with the unit vectors,
vmapped in chunks so the tangent copies of the partials stay within a
few GiB.  The approximation

    lnL(b) ~= lnL0 + g.(b-b0) + (b-b0)' H (b-b0) / 2

replaces the full traversal inside MCMC moves, turning each likelihood
evaluation into a vector-matrix-vector product: a fastlk chain
launches no pruning kernel.  Wired into the bayes tier as
`MCMC(..., fastlk=True)` / `run_phytime(..., fastlk=True)`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from phyml_tpu_torch.ops.likelihood import TreeArrays

F64 = torch.float64
# device memory the chunked Hessian may hold at once, and the float64
# [n_nodes, C, ns, P] tensors one tangent direction holds (the forward
# partials, their tangents and what the reverse pass saves)
HESSIAN_BYTES = 4 * 2 ** 30
TENSORS_PER_TANGENT = 8


class NormalApprox(NamedTuple):
    b0: torch.Tensor      # [n_nodes] expansion point (branch lengths)
    lnL0: torch.Tensor
    grad: torch.Tensor    # [n_nodes]
    hess: torch.Tensor    # [n_nodes, n_nodes]
    mask: torch.Tensor    # 1 for real free edges (root slot 0)

    def loglik(self, blen):
        """The quadratic surface at blen (float64 0-d tensor on the
        expansion's device)."""
        blen = torch.as_tensor(blen).to(self.b0.device, F64)
        d = (blen - self.b0) * self.mask
        return (self.lnL0 + self.grad @ d
                + 0.5 * d @ (self.hess @ d))


def hessian_chunk(engine) -> int:
    """Tangent directions a vmapped chunk of the Hessian carries: all
    of them on the CPU, HESSIAN_BYTES' worth on the card."""
    n = engine.n_nodes
    if engine.device.type != "cuda":
        return n
    per = TENSORS_PER_TANGENT * n * engine.C * engine.ns * engine.P * 8
    return max(1, min(n, HESSIAN_BYTES // per))


def fit_normal_approx(engine, params, tree: TreeArrays, weights=None,
                      chunk_size: int | None = None) -> NormalApprox:
    """Expand lnL around the given branch lengths, in float64 on the
    engine's device.  Call at a (near-)optimal tree: the reference
    requires the same (dLk ~ 0) for the approximation to be
    trustworthy."""
    sys = engine._system(params, dtype=F64)
    child = torch.as_tensor(tree.child)
    w = engine._w(weights)
    b0 = torch.as_tensor(tree.blen).to(engine.device, F64)

    def f(blen):
        return engine.loglik_functional(sys, child, blen, w)

    grad_f = torch.func.grad(f)
    grad, lnL0 = torch.func.grad_and_value(f)(b0)

    def hvp(v):
        return torch.func.jvp(grad_f, (b0,), (v,))[1]

    n_nodes = b0.shape[0]
    eye = torch.eye(n_nodes, dtype=F64, device=b0.device)
    hess = torch.func.vmap(hvp, chunk_size=chunk_size or
                           hessian_chunk(engine))(eye)
    mask = torch.ones(n_nodes, dtype=F64, device=b0.device)
    mask[n_nodes - 1] = 0.0
    return NormalApprox(b0=b0, lnL0=lnL0.detach(), grad=grad.detach(),
                        hess=hess.detach(), mask=mask)
