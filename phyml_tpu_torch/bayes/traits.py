"""Continuous-trait / phylogeography models on time-trees
(≙ the PhyREX Gaussian stack: rw.c, rrw.c, ibm.c, iwn.c, iou.c,
velocity.c, location.c).

Port of phyml_tpu/bayes/traits.py.  All of these are linear-Gaussian
models of a D-dimensional trait (coordinates, in PhyREX) evolving along
the chronogram:

  * RW    — Brownian motion, variance sigma^2 * dt per edge
            (rw.c; LOCATION_Lk dispatch location.c:40)
  * RRW   — relaxed random walk: per-edge lognormal scalers r_e,
            variance sigma^2 * r_e * dt (rrw.c)
  * IBM   — integrated Brownian motion: velocity is Brownian, the
            position integrates it (ibm.c, velocity.c)
  * IWN   — integrated white noise: velocity redrawn independently
            each edge (iwn.c)
  * IOU   — integrated Ornstein-Uhlenbeck: velocity mean-reverts with
            strength theta (iou.c)

The densities are float64 torch functions of host tensors, and stay
differentiable in the heights, sigma^2 and the RRW scalers: the chain's
MALA move takes torch.autograd.grad through its log prior, which holds
the location term.  So no value on that path is read back, and no
tensor autograd needs is written in place.  Where phyml_tpu scans the
child table (`lax.scan`), the port walks it a LEVEL at a time: the
internal nodes whose children are all done (upward), or whose parents
are (downward), are one gather and one out-of-place `index_put` each,
so a 128-taxon tree takes tens of steps, not 127.  The MRCA tables are
derived on the host from the integer child table at every evaluation
(phyml_tpu traces them when the genealogy is chain state), cached by
the table's bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LOG2PI = float(np.log(2.0 * np.pi))
F64 = torch.float64

RW = "rw"
RRW = "rrw"
IBM = "ibm"
IWN = "iwn"
IOU = "iou"


def _host_child(child) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(
        child.detach().cpu() if isinstance(child, torch.Tensor) else child,
        dtype=np.int64))


_TOPO_CACHE: dict = {}


def _topology(child) -> dict:
    """Host tables of one child table, cached by its bytes: parent
    [n_nodes], the upward levels (rows of internal nodes whose
    children lie in earlier levels) and the downward levels (non-root
    nodes whose parents lie in earlier levels, root first)."""
    ch = _host_child(child)
    key = ch.tobytes()
    hit = _TOPO_CACHE.get(key)
    if hit is not None:
        return hit
    n = ch.shape[0] + 1
    n_nodes = 2 * n - 1
    parent = np.full(n_nodes, n_nodes - 1, dtype=np.int64)
    up = np.zeros(n_nodes, dtype=np.int64)
    for i in range(n - 1):
        parent[ch[i, 0]] = n + i
        parent[ch[i, 1]] = n + i
        up[n + i] = max(up[ch[i, 0]], up[ch[i, 1]]) + 1
    depth = np.zeros(n_nodes, dtype=np.int64)
    for u in range(n_nodes - 2, -1, -1):
        depth[u] = depth[parent[u]] + 1
    rows = np.arange(n - 1)
    up_rows = [rows[up[n:] == k] for k in range(1, int(up.max()) + 1)] \
        if n > 1 else []
    hit = dict(
        parent=parent,
        # per upward level: (its nodes, their children [k, 2])
        up=[(torch.as_tensor(r + n), torch.as_tensor(ch[r]))
            for r in up_rows],
        down=[torch.as_tensor(np.nonzero(depth == k)[0]) for k in
              range(1, int(depth.max()) + 1)],
        child=torch.as_tensor(ch))
    if len(_TOPO_CACHE) > 4096:
        _TOPO_CACHE.clear()
    _TOPO_CACHE[key] = hit
    return hit


def _as_f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64)


# ----------------------------------------------------------------------
# BM / RRW: exact pruning (contrasts)
# ----------------------------------------------------------------------
def brownian_loglik(tip_x, child, edge_var):
    """Exact log-likelihood of tip values under Brownian motion with
    per-edge variances, root integrated out with an (improper) flat
    prior — the standard REML/contrast form used for RRW scoring
    (≙ RW_Lk/RRW_Lk via LOCATION_Lk location.c:40).

    tip_x    [n, D]   observed tip coordinates
    child    [n-1, 2] postorder child table (TimeTree layout)
    edge_var [2n-1]   variance accumulated on the edge above each node
                      (root slot ignored)

    Returns the summed log-density of the n-1 independent contrasts
    over all D dimensions."""
    tip_x = _as_f64(tip_x)
    edge_var = _as_f64(edge_var)
    n, D = tip_x.shape
    topo = _topology(child)
    mu = torch.cat([tip_x, tip_x.new_zeros((n - 1, D))])
    # extra variance on top of the node's own edge (from pruning below)
    add = edge_var.new_zeros(2 * n - 1)
    lognorm = edge_var.new_zeros(())
    for u, cc in topo["up"]:
        v = edge_var[cc] + add[cc]                 # [k, 2]
        m = mu[cc]                                 # [k, 2, D]
        vsum = v[:, 0] + v[:, 1]
        diff = m[:, 0] - m[:, 1]
        # contrast density: each of D dims ~ N(0, vsum)
        lc = -0.5 * torch.sum(diff * diff, -1) / vsum \
            - 0.5 * D * (torch.log(vsum) + LOG2PI)
        lognorm = lognorm + torch.sum(lc)
        w0 = (v[:, 1] / vsum)[:, None]
        mu = mu.index_put((u,), w0 * m[:, 0] + (1.0 - w0) * m[:, 1])
        add = add.index_put((u,), v[:, 0] * v[:, 1] / vsum)
    return lognorm


def rrw_edge_var(sigma2, dt, log_scalers, root):
    """Per-edge variances sigma^2 * r_e * dt_e for the relaxed random
    walk (rrw.c); r_e = exp(log_scalers), pinned at the root."""
    log_scalers = _as_f64(log_scalers)
    is_root = torch.arange(log_scalers.shape[0]) == root
    r = torch.where(is_root, torch.ones_like(log_scalers),
                    torch.exp(log_scalers))
    return sigma2 * r * dt


def rrw_scaler_log_prior(log_scalers, nu, root):
    """iid lognormal prior on the RRW edge scalers, mean 1
    (≙ RRW_Prior rrw.c)."""
    log_scalers = _as_f64(log_scalers)
    nu = torch.clamp(_as_f64(nu), min=1e-10)
    mask = (torch.arange(log_scalers.shape[0]) != root).to(F64)
    mu = -0.5 * nu * nu
    z = (log_scalers - mu) / nu
    lp = -0.5 * (z * z + LOG2PI) - torch.log(nu)
    return torch.sum(lp * mask)


# ----------------------------------------------------------------------
# Integrated models: exact per-edge (A, Q) over state (position, velocity)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class IntegratedModel:
    """kind in {'ibm', 'iwn', 'iou'}; theta only used by IOU."""
    kind: str = IBM

    def transition(self, dt, sigma2, theta=1.0):
        """Returns A [.., 2, 2], Q [.., 2, 2] for state (x, v):
        x_child = A @ x_parent + w, w ~ N(0, Q).  Exact integrals:
          IBM: v Brownian;      Q = s2 [[dt^3/3, dt^2/2],[dt^2/2, dt]]
          IWN: v ~ iid N(0,s2) per edge held constant across it:
               x' = x + v' dt  => correlated (x', v') given x
          IOU: dv = -theta v dt + s dW; x integrates v (exact OU
               moments, iou.c)
        """
        dt = _as_f64(dt)
        z = torch.zeros_like(dt)
        o = torch.ones_like(dt)
        if self.kind == IBM:
            A = torch.stack([torch.stack([o, dt], -1),
                             torch.stack([z, o], -1)], -2)
            q11 = sigma2 * dt ** 3 / 3.0
            q12 = sigma2 * dt ** 2 / 2.0
            q22 = sigma2 * dt
        elif self.kind == IWN:
            # v' fresh each edge; x' = x + v' dt
            A = torch.stack([torch.stack([o, z], -1),
                             torch.stack([z, z], -1)], -2)
            q11 = sigma2 * dt * dt
            q12 = sigma2 * dt
            q22 = sigma2 * o
        elif self.kind == IOU:
            th = torch.clamp(_as_f64(theta), min=1e-8)
            e = torch.exp(-th * dt)
            A = torch.stack([torch.stack([o, (1 - e) / th], -1),
                             torch.stack([z, e], -1)], -2)
            s = sigma2 / (2 * th)
            q22 = s * (1 - e ** 2)
            q12 = (sigma2 / (2 * th ** 2)) * (1 - e) ** 2
            q11 = (sigma2 / th ** 2) * (
                dt - 2 * (1 - e) / th + (1 - e ** 2) / (2 * th))
        else:
            raise ValueError(self.kind)
        Q = torch.stack([torch.stack([q11, q12], -1),
                         torch.stack([q12, q22], -1)], -2)
        return A, Q

    # ------------------------------------------------------------------
    def transition_logpdf(self, states, child, dt, sigma2, theta=1.0,
                          jitter=1e-12):
        """Joint log-density of latent node states given the root
        (flat root prior): sum over non-root nodes of
        log N(state_child ; A state_parent, Q) — the augmented-MCMC
        scoring used for velocities/locations (velocity.c, phyrex.c).

        states [n_nodes, D, 2]  (position, velocity) per node per dim
        """
        states = _as_f64(states)
        n_nodes = states.shape[0]
        n = (n_nodes + 1) // 2
        parent = _parent_from_child(child, n)
        A, Q = self.transition(dt, sigma2, theta)      # [N, 2, 2]
        mean = torch.einsum("nij,ndj->ndi", A, states[parent])
        resid = states - mean                          # [N, D, 2]
        Qj = Q + jitter * torch.eye(2, dtype=F64)
        Qinv = torch.linalg.inv(Qj)
        _, logdet = torch.linalg.slogdet(Qj)
        quad = torch.einsum("ndi,nij,ndj->nd", resid, Qinv, resid)
        D = states.shape[1]
        per_node = -0.5 * (quad.sum(-1) + D * (logdet + 2 * LOG2PI))
        mask = (torch.arange(n_nodes) != n_nodes - 1).to(F64)
        return torch.sum(per_node * mask)

    # ------------------------------------------------------------------
    def marginal_loglik(self, tip_x, child, dt, sigma2, theta=1.0,
                        root_var=1e6):
        """Exact marginal log-likelihood of tip POSITIONS with all
        latent velocities and internal positions integrated out
        (replaces the reference's *_Integrated_Lk_Down recursions,
        ibm.c/iou.c).  The root state is N(0, root_var * I).

        The state process is linear-Gaussian with invertible per-edge
        transitions (IBM/IOU), so the joint tip covariance has the
        closed form
            Cov(x_i, x_j) = h_i  G_{mrca(i,j)}  h_j^T,
        where T_u is the accumulated root->u transition product,
        h_u = H T_u (H = position row), and
        G_a = T_a^{-1} Sigma_a T_a^{-T} with Sigma_a the marginal
        state covariance at a: batched 2x2 algebra and one [n, n]
        Cholesky.  IWN has singular transitions but its positions are
        exactly Brownian with per-edge variance sigma^2*dt^2, so it
        routes through the scalar path-variance construction.

        tip_x [n, D]; dt [n_nodes]; returns a proper scalar loglik."""
        tip_x = _as_f64(tip_x)
        n, D = tip_x.shape
        dt = _as_f64(dt)
        n_nodes = 2 * n - 1
        topo = _topology(child)
        if "mrca" not in topo:
            topo["mrca"] = torch.as_tensor(
                _mrca_table(topo["child"].numpy(), n))
        mrca = topo["mrca"]
        parent = torch.as_tensor(topo["parent"])
        if self.kind == IWN:
            # positions are BM with edge variance sigma2*dt^2: the
            # per-edge velocity is iid, so position increments are
            # independent N(0, sigma2*dt^2)
            ev = sigma2 * dt * dt
            cum = _path_cumsum(ev, parent, n_nodes)      # [n_nodes]
            S = root_var + cum[mrca]                     # [n, n]
        else:
            A, Q = self.transition(dt, sigma2, theta)        # [N, 2, 2]
            eye = torch.eye(2, dtype=F64)
            # parents first: one level of nodes at a time, each from its
            # parent's (Sigma, T)
            Sig = torch.cat([A.new_zeros((n_nodes - 1, 2, 2)),
                             (root_var * eye)[None]])
            T = torch.cat([A.new_zeros((n_nodes - 1, 2, 2)), eye[None]])
            for u in topo["down"]:
                Au, pu = A[u], parent[u]
                Sig = Sig.index_put(
                    (u,), Au @ Sig[pu] @ Au.transpose(-1, -2) + Q[u])
                T = T.index_put((u,), Au @ T[pu])
            Tinv = torch.linalg.inv(T)
            G = torch.einsum("nij,njk,nlk->nil", Tinv, Sig, Tinv)
            h = T[:n, 0, :]                                  # [n, 2]
            S = torch.einsum("ip,ijpq,jq->ij", h, G[mrca], h)

        S = 0.5 * (S + S.T)
        # PD by construction; the regularizer only guards fp32 runs
        # (relative to machine eps so fp64 parity is untouched)
        eps = float(torch.finfo(S.dtype).eps)
        jit_scale = eps * torch.mean(torch.diagonal(S))
        L, info = torch.linalg.cholesky_ex(
            S + jit_scale * torch.eye(n, dtype=S.dtype))
        if int(info) != 0:
            # not positive definite in float64 (phyml_tpu's Cholesky
            # gives NaN here, which the chain's accept test rejects)
            return torch.full((), float("nan"), dtype=F64)
        z = torch.linalg.solve_triangular(L, tip_x, upper=False)
        ldet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        return -0.5 * (torch.sum(z * z) + D * ldet + D * n * LOG2PI)


def _path_cumsum(edge_val, parent, n_nodes):
    """cum[u] = sum of edge_val along the path u -> root, by pointer
    doubling: invariant S_k(u) = sum over the path u .. anc_k(u)
    (2^k-th ancestor, clamped at the root, where the value is 0)."""
    edge_val = _as_f64(edge_val)
    parent = torch.as_tensor(parent, dtype=torch.int64)
    S = torch.where(torch.arange(n_nodes) == n_nodes - 1,
                    torch.zeros_like(edge_val), edge_val)
    anc = parent
    for _ in range(int(np.ceil(np.log2(max(n_nodes, 2)))) + 1):
        S = S + S[anc]
        anc = anc[anc]
    return S


def _mrca_table(child_np, n):
    """[n, n] tip-pair MRCA node ids (host-side, topology-only): every
    pair of tips below the two children of internal node u meets at u
    (postorder, so each pair is written once)."""
    child_np = np.asarray(child_np, dtype=np.int64)
    below = [np.asarray([u]) for u in range(n)]
    M = np.zeros((n, n), dtype=np.int64)
    M[np.arange(n), np.arange(n)] = np.arange(n)
    for i in range(n - 1):
        a, b = below[child_np[i, 0]], below[child_np[i, 1]]
        M[np.ix_(a, b)] = n + i
        M[np.ix_(b, a)] = n + i
        below.append(np.concatenate([a, b]))
    return M


def _parent_from_child(child, n):
    """int64 [2n-1] parent of every node (the root its own)."""
    return torch.as_tensor(_topology(child)["parent"])


def _psd_sqrt(cov):
    """Symmetric square root with negative eigenvalues (conditioning
    cancellation noise) clamped to zero - Cholesky is too brittle for
    posterior covariances whose observed components are exactly
    deterministic."""
    cov = 0.5 * (cov + cov.T)
    w, U = np.linalg.eigh(cov)
    w = np.clip(w, 0.0, None)
    return U * np.sqrt(w)[None, :]


def _mrca_table_all(child_np, n):
    """[n_nodes, n_nodes] MRCA node ids for ALL node pairs (host-side,
    topology-only), and the parent vector: internal node u is the MRCA
    of every pair split between its two subtrees and of itself with
    every node below it."""
    child_np = np.asarray(child_np, dtype=np.int64)
    n_nodes = 2 * n - 1
    parent = np.full(n_nodes, n_nodes - 1, dtype=np.int64)
    below = [np.asarray([u]) for u in range(n)]
    M = np.zeros((n_nodes, n_nodes), dtype=np.int64)
    M[np.arange(n_nodes), np.arange(n_nodes)] = np.arange(n_nodes)
    for i in range(n - 1):
        u = n + i
        c0, c1 = child_np[i]
        parent[c0] = parent[c1] = u
        a, b = below[c0], below[c1]
        M[np.ix_(a, b)] = u
        M[np.ix_(b, a)] = u
        sub = np.concatenate([a, b])
        M[u, sub] = u
        M[sub, u] = u
        below.append(np.concatenate([sub, [u]]))
    return M, parent


def posterior_state_samples(kind, tip_x, child, dt, sigma2,
                            theta=1.0, root_var=1e6,
                            root_vel_var=None, n_samples=64,
                            rng=None):
    """EXACT posterior samples of all latent (position, velocity)
    node states given the observed tip positions, for the integrated
    movement models.

    The reference samples velocities with Metropolis-Hastings over an
    augmented likelihood (velocity.c:64 VELOC_Augmented_Lk_Locations,
    :213 VELOC_Augmented_Lk_Velocity).  These models are
    linear-Gaussian, so the posterior over every latent state is
    itself Gaussian with closed-form moments: this routine assembles
    the joint prior covariance from the per-edge (A, Q) transition
    products (the same T/G/Sigma algebra as marginal_loglik),
    conditions on the tip positions, and draws iid samples from the
    numpy Generator `rng` (phyml_tpu's calls in its order, so one seed
    gives both packages the same draws).

    IWN's transitions are singular (the velocity is redrawn each
    edge), but given positions at both edge ends the edge velocity is
    DETERMINED: v_u = (x_u - x_parent) / dt_u; so IWN routes through
    scalar Brownian smoothing of positions.

    Returns (samples [S, n_nodes, D, 2], mean [n_nodes, D, 2],
    sd [n_nodes, D, 2]); state component 0 = position, 1 = velocity
    (IWN: the velocity on the edge above the node; root velocity 0).

    root_var is the (diffuse) prior variance on the root POSITION;
    root_vel_var the prior variance on the root VELOCITY, by default
    the proper data scale sigma2 * tree height (a diffuse velocity
    prior lets a global drift mode absorb the tip-position signal)."""
    rng = rng or np.random.default_rng(0)
    tip_x = np.asarray(tip_x, dtype=np.float64)
    child_np = _host_child(child)
    dt = np.asarray(dt, dtype=np.float64)
    n, D = tip_x.shape
    n_nodes = 2 * n - 1
    mrca, parent = _mrca_table_all(child_np, n)

    if kind == IWN:
        # positions are Brownian with per-edge variance s2*dt^2
        ev = (sigma2 * dt * dt).copy()
        ev[n_nodes - 1] = 0.0
        # parents have higher postorder ids, so a descending sweep
        # accumulates root->u path variances correctly
        cum = np.zeros(n_nodes)
        for u in range(n_nodes - 2, -1, -1):
            cum[u] = cum[parent[u]] + ev[u]
        C = root_var + cum[mrca]                       # [N, N]
        obs = np.arange(n)
        lat = np.arange(n, n_nodes)
        Cyy = C[np.ix_(obs, obs)]
        Cly = C[np.ix_(lat, obs)]
        Cll = C[np.ix_(lat, lat)]
        K = np.linalg.solve(Cyy, Cly.T).T              # [L, n]
        mean_lat = K @ tip_x                           # [L, D]
        cov_lat = Cll - K @ Cly.T
        L = _psd_sqrt(cov_lat)
        xs = np.empty((n_samples, n_nodes, D))
        xs[:, :n] = tip_x
        z = rng.standard_normal((n_samples, len(lat), D))
        xs[:, n:] = mean_lat + np.einsum("ij,sjd->sid", L, z)
        # velocities from increments
        smp = np.zeros((n_samples, n_nodes, D, 2))
        smp[..., 0] = xs
        dts = np.maximum(dt, 1e-12)
        for u in range(n_nodes - 1):
            smp[:, u, :, 1] = (xs[:, u] - xs[:, parent[u]]) / dts[u]
        # exact moments (positions exact; velocity moments propagate
        # linearly from the position posterior)
        mean_x = np.concatenate([tip_x, mean_lat], axis=0)
        sd_x = np.zeros((n_nodes, 1))
        sd_x[n:, 0] = np.sqrt(np.clip(np.diag(cov_lat), 0, None))
        mean = np.zeros((n_nodes, D, 2))
        sd = np.zeros((n_nodes, D, 2))
        mean[..., 0] = mean_x
        sd[..., 0] = sd_x
        cov_full = np.zeros((n_nodes, n_nodes))
        cov_full[np.ix_(range(n, n_nodes), range(n, n_nodes))] = \
            cov_lat
        for u in range(n_nodes - 1):
            pu = parent[u]
            mean[u, :, 1] = (mean_x[u] - mean_x[pu]) / dts[u]
            var_v = (cov_full[u, u] + cov_full[pu, pu]
                     - 2 * cov_full[u, pu]) / dts[u] ** 2
            sd[u, :, 1] = np.sqrt(max(var_v, 0.0))
        return smp, mean, sd

    model = IntegratedModel(kind=kind)
    A, Q = model.transition(torch.as_tensor(dt), sigma2, theta)
    A = A.numpy().astype(np.float64, copy=True)
    Q = Q.numpy().astype(np.float64, copy=True)
    eye = np.eye(2)
    A[n_nodes - 1] = eye
    Q[n_nodes - 1] = 0.0
    if root_vel_var is None:
        # proper prior at the natural scale: the velocity variance a
        # Brownian velocity accumulates over one tree height
        depth = np.zeros(n_nodes)
        for u in range(n_nodes - 2, -1, -1):
            depth[u] = depth[parent[u]] + dt[u]
        root_vel_var = float(sigma2) * max(float(depth.max()), 1e-6)
    T = np.zeros((n_nodes, 2, 2))
    Sig = np.zeros((n_nodes, 2, 2))
    T[n_nodes - 1] = eye
    Sig[n_nodes - 1] = np.diag([root_var, root_vel_var])
    for u in range(n_nodes - 2, -1, -1):
        p = parent[u]
        # parents always have higher postorder ids, so a descending
        # sweep visits parents first
        T[u] = A[u] @ T[p]
        Sig[u] = A[u] @ Sig[p] @ A[u].T + Q[u]
    Tinv = np.linalg.inv(T)
    G = np.einsum("nij,njk,nlk->nil", Tinv, Sig, Tinv)
    # joint covariance over all stacked states [N*2, N*2]
    C = np.einsum("uip,uwpq,wjq->uiwj", T, G[mrca], T)
    C = C.reshape(n_nodes * 2, n_nodes * 2)
    obs = 2 * np.arange(n)                 # tip position components
    lat = np.setdiff1d(np.arange(2 * n_nodes), obs)
    Cyy = C[np.ix_(obs, obs)]
    Cly = C[np.ix_(lat, obs)]
    Cll = C[np.ix_(lat, lat)]
    K = np.linalg.solve(Cyy, Cly.T).T
    mean_lat = K @ tip_x
    cov_lat = Cll - K @ Cly.T
    L = _psd_sqrt(cov_lat)
    flat = np.zeros((n_samples, 2 * n_nodes, D))
    flat[:, obs] = tip_x
    z = rng.standard_normal((n_samples, len(lat), D))
    flat[:, lat] = mean_lat + np.einsum("ij,sjd->sid", L, z)
    smp = flat.reshape(n_samples, n_nodes, 2, D).transpose(0, 1, 3, 2)
    # exact posterior moments (not sample averages)
    mean_flat = np.zeros((2 * n_nodes, D))
    mean_flat[obs] = tip_x
    mean_flat[lat] = mean_lat
    sd_flat = np.zeros((2 * n_nodes, 1))
    sd_flat[lat, 0] = np.sqrt(np.clip(np.diag(cov_lat), 0, None))
    mean = mean_flat.reshape(n_nodes, 2, D).transpose(0, 2, 1)
    sd = np.broadcast_to(
        sd_flat.reshape(n_nodes, 2, 1), (n_nodes, 2, D)
    ).transpose(0, 2, 1).copy()
    return smp, mean, sd


# ----------------------------------------------------------------------
# dispatch (≙ LOCATION_Lk location.c:40)
# ----------------------------------------------------------------------
def location_loglik(kind, tip_x, child, dt, sigma2,
                    log_scalers=None, nu=None, theta=1.0):
    """Score tip coordinates under the named movement model."""
    n = tip_x.shape[0]
    root = 2 * n - 2
    if kind == RW:
        return brownian_loglik(tip_x, child, sigma2 * _as_f64(dt))
    if kind == RRW:
        ev = rrw_edge_var(sigma2, _as_f64(dt), log_scalers, root)
        lp = brownian_loglik(tip_x, child, ev)
        return lp + rrw_scaler_log_prior(log_scalers, nu, root)
    return IntegratedModel(kind=kind).marginal_loglik(
        tip_x, child, dt, sigma2, theta)
