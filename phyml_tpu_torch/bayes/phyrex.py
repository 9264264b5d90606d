"""PhyREX: joint Bayesian phylogeography (≙ phyrex.c
PHYREX_XML/PHYREX_Lk/PHYREX_MCMC phyrex.c:37/1130/1234).

Port of phyml_tpu/bayes/phyrex.py.  The reference's PhyREX couples the
sequence likelihood with a spatial model of lineage movement (relaxed
random walk and its integrated relatives; the SLFV event-disk model is
the other branch of location.c's dispatch).  Here the same joint
posterior runs through the `bayes.mcmc` chain: sequences via the
likelihood engine (one pass of the route's slot kernel per lnL on the
card: K1, or K4 at 20 states), coordinates via `bayes.traits`
(RW/RRW/IBM/IWN/IOU) on the host in float64, node times / clock /
movement parameters all sampled in one chain; the SLFV model through
`bayes.slfv.SLFVJointSampler`.

Post-processing reconstructs ancestral locations for the Brownian
family as exact Gaussian conditional means E[x_internal | x_tips]
(the GLS form of PHYREX's sampled ancestral locations).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from phyml_tpu_torch.bayes.chrono import TimeTree
from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
from phyml_tpu_torch.bayes.rates import RateModel
from phyml_tpu_torch.bayes.times import TimePrior
from phyml_tpu_torch.bayes.traits import _mrca_table_all


@dataclass
class PhyrexResult:
    tree: TimeTree
    state: object
    trace: np.ndarray
    acc_rate: np.ndarray
    sigma2: float               # movement variance per unit time
    anc_locations: np.ndarray   # [n_nodes, D] (tips = observed)
    summary: dict
    # integrated movement models only (ibm/iwn/iou): exact posterior
    # velocity draws from traits.posterior_state_samples
    velocity_samples: np.ndarray | None = None   # [S, n_nodes, D]
    velocity_mean: np.ndarray | None = None      # [n_nodes, D]
    velocity_sd: np.ndarray | None = None
    # the chain that ran: an MCMC, or the SLFVJointSampler
    sampler: object = None


def ancestral_locations_dense(tt: TimeTree, tip_x, sigma2,
                              edge_scalers=None, root_var=1e4):
    """O(n^3) reference implementation (dense tip covariance solve);
    kept as the oracle for the message-passing version below."""
    n = tt.n_otu
    n_nodes = tt.n_nodes
    dt = tt.edge_durations()
    ev = sigma2 * dt
    if edge_scalers is not None:
        ev = ev * np.asarray(edge_scalers)
    M, parent = _mrca_table_all(np.asarray(tt.child), n)
    # cum[u] = variance accumulated root -> u
    cum = np.zeros(n_nodes)
    for u in range(n_nodes - 2, -1, -1):
        cum[u] = cum[parent[u]] + ev[u]
    C = root_var + cum[M]                     # [n_nodes, n_nodes]
    S = C[:n, :n]
    Sinv_x = np.linalg.solve(S, np.asarray(tip_x))
    out = C[:, :n] @ Sinv_x                   # conditional means
    out[:n] = np.asarray(tip_x)
    return out


def ancestral_locations(tt: TimeTree, tip_x, sigma2,
                        edge_scalers=None, root_var=1e4):
    """Exact BM/RRW conditional means of internal-node locations given
    tip locations via Gaussian belief propagation on the tree — O(n)
    per trait dimension, the same message-passing structure as the
    reference's RW_Integrated_Lk_Down (rw.c:226).  Matches the dense
    GLS solution to numerical precision (tested)."""
    n = tt.n_otu
    n_nodes = tt.n_nodes
    x = np.asarray(tip_x, dtype=np.float64)
    dt = tt.edge_durations()
    ev = sigma2 * dt
    if edge_scalers is not None:
        ev = ev * np.asarray(edge_scalers)
    child = np.asarray(tt.child)
    D = x.shape[1]

    # upward pass: message (m_u, v_u) = posterior of node u's location
    # given data BELOW u (v = variance; tips are exact: v = 0)
    m = np.zeros((n_nodes, D))
    v = np.zeros(n_nodes)
    m[:n] = x
    for i in range(n - 1):
        c0, c1 = int(child[i, 0]), int(child[i, 1])
        u = n + i
        va = v[c0] + ev[c0]
        vb = v[c1] + ev[c1]
        v[u] = va * vb / (va + vb)
        m[u] = (m[c0] * vb + m[c1] * va) / (va + vb)

    # downward pass: fold in the data OUTSIDE each node.  d/w is the
    # outside message at u (w = inf at the root for an improper /
    # root_var-flat prior: the root conditional mean is the upward
    # combine, matching the dense GLS limit).
    out = np.zeros((n_nodes, D))
    d_msg = np.zeros((n_nodes, D))
    w_msg = np.full(n_nodes, np.inf)
    root = n_nodes - 1
    w_msg[root] = root_var
    d_msg[root] = 0.0
    out[root] = _combine(m[root], v[root], d_msg[root], w_msg[root])
    for i in range(n - 2, -1, -1):
        c0, c1 = int(child[i, 0]), int(child[i, 1])
        u = n + i
        for c, s in ((c0, c1), (c1, c0)):
            # outside of c = (outside of u) ⊗ (upward of sibling s),
            # pushed through c's edge variance
            dm, wm = _combine2(d_msg[u], w_msg[u],
                               m[s], v[s] + ev[s])
            d_msg[c] = dm
            w_msg[c] = wm + ev[c]
        out[c0] = _combine(m[c0], v[c0], d_msg[c0], w_msg[c0])
        out[c1] = _combine(m[c1], v[c1], d_msg[c1], w_msg[c1])
    out[:n] = x
    return out


def _combine2(m1, v1, m2, v2):
    """Product of two Gaussian messages -> (mean, variance), handling
    infinite (uninformative) variances."""
    if np.isinf(v1):
        return m2, v2
    if np.isinf(v2):
        return m1, v1
    w = v1 * v2 / (v1 + v2)
    return (m1 * v2 + m2 * v1) / (v1 + v2), w


def _combine(m1, v1, m2, v2):
    return _combine2(m1, v1, m2, v2)[0]


def run_phyrex(
    aln,
    coords,
    time_tree: TimeTree,
    model=None,
    trait_kind: str = "rrw",
    rate_kind: str = "lognormal",
    prior_kind: str = "coalescent",
    settings: MCMCSettings | None = None,
    trace_path: str | None = None,
    verbose: bool = False,
    sample_topology: bool | None = None,
    spatial_dist: str = "euclidean",
    engine=None,
    device=None,
) -> PhyrexResult:
    """Joint sequence + coordinate phylogeography on `device` (the
    CUDA device unless given; float32 on the card, float64 on the
    CPU), or on `engine` when one is given for the alignment and
    model.  `coords` [n_otu, D] in taxon order (lat/lon or any
    Euclidean projection, ≙ the <coordinates> blocks of phyrex XML).

    sample_topology (default: True for rw/rrw movement models): the
    chain jointly samples (genealogy, node times, locations) via the
    time-tree moves — the reference's PHYREX_MCMC samples the
    genealogy too (phyrex.c:1234); pass True to enable it for the
    integrated models (ibm/iwn/iou) as well (≙ ibm.c:930, iwn.c, iou.c
    inside the full PhyREX sampler).  The substitution parameters are
    the model's initial ones, as phyml_tpu's run_phyrex takes them."""
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, default_device

    if model is None:
        model = SubstModel(datatype=aln.datatype, name=(
            "HKY85" if aln.datatype == "nt" else "LG"), n_classes=4)
    if engine is None:
        device = default_device(device)
        engine = LikelihoodEngine(
            aln, model, device=device,
            dtype=torch.float32 if device.type == "cuda" else torch.float64)
    params = model.init_params(aln.obs_state_freqs)

    if trait_kind == "slfv":
        # the reference's DEFAULT PhyREX model (init.c:6097
        # SLFV_GAUSSIAN): joint trans-dimensional sampling of the
        # event-disk history, genealogy, locations, clock AND the
        # sequence likelihood (phyrex.c:1234 PHYREX_MCMC)
        return _run_phyrex_slfv(engine, model, params, coords,
                                time_tree, settings, trace_path,
                                verbose, spatial_dist)

    if sample_topology is None:
        sample_topology = trait_kind in ("rw", "rrw")
    mcmc = MCMC(engine, model, params, time_tree,
                RateModel(kind=rate_kind), TimePrior(kind=prior_kind),
                settings=settings or MCMCSettings(),
                trait_x=np.asarray(coords), trait_kind=trait_kind,
                sample_topology=sample_topology)
    fh = open(trace_path, "w") if trace_path else None
    try:
        state, trace, acc = mcmc.run(trace_fh=fh, verbose=verbose)
    finally:
        if fh:
            fh.close()

    heights = state.heights.numpy().copy()
    child_np = state.child.numpy().copy()
    dated = TimeTree(n_otu=time_tree.n_otu, child=child_np,
                     heights=heights, names=list(time_tree.names))
    s2 = float(torch.exp(state.log_s2x))
    scalers = (torch.exp(state.trait_lr).numpy()
               if trait_kind == "rrw" else None)
    vel_samples = vel_mean = vel_sd = None
    if trait_kind in ("rw", "rrw"):
        anc = ancestral_locations(dated, coords, s2,
                                  edge_scalers=scalers)
    else:
        # integrated movement models (ibm/iwn/iou): the latent
        # (position, velocity) posterior is Gaussian, so ancestral
        # locations AND velocities come from the exact smoother
        # (traits.posterior_state_samples) conditional on the chain's
        # final (genealogy, times, sigma^2) — iid draws in place of
        # the reference's MH velocity moves (velocity.c:64/:213)
        from phyml_tpu_torch.bayes.traits import posterior_state_samples
        parent = np.full(dated.n_nodes, dated.root, dtype=np.int64)
        for i in range(dated.n_otu - 1):
            parent[child_np[i, 0]] = dated.n_otu + i
            parent[child_np[i, 1]] = dated.n_otu + i
        dt = np.maximum(heights[parent] - heights, 0.0)
        dt[dated.root] = 0.0
        vel_samples, smean, ssd = posterior_state_samples(
            trait_kind, np.asarray(coords), child_np, dt, s2,
            n_samples=128,
            rng=np.random.default_rng(
                (settings.seed if settings else 0) + 99))
        anc = smean[:, :, 0]
        vel_mean = smean[:, :, 1]
        vel_sd = ssd[:, :, 1]
    summary = {
        "n_iter": trace.shape[0],
        "posterior_final": float(trace[-1, 0]),
        "lnL_final": float(trace[-1, 1]),
        "root_height": float(heights[dated.root]),
        "sigma2": s2,
        "root_location": anc[dated.root].tolist(),
        "clock_rate": float(torch.exp(state.log_clock)),
        "acceptance": {nm: float(a) for nm, a
                       in zip(MCMC.MOVE_NAMES, acc)},
    }
    if vel_samples is not None:
        # exact iid draws: ESS == number of draws (reported per the
        # usual autocorrelation estimator as a consistency check)
        from phyml_tpu_torch.bayes.diagnostics import effective_sample_size
        root_v = vel_samples[:, child_np[-1, 0], 0, 1]
        summary["velocity_ess"] = float(effective_sample_size(root_v))
        summary["n_velocity_samples"] = int(vel_samples.shape[0])
    return PhyrexResult(tree=dated, state=state, trace=trace,
                        acc_rate=acc, sigma2=s2, anc_locations=anc,
                        summary=summary,
                        velocity_samples=(
                            None if vel_samples is None
                            else vel_samples[:, :, :, 1]),
                        velocity_mean=vel_mean, velocity_sd=vel_sd,
                        sampler=mcmc)


def print_summary(res: PhyrexResult, out=sys.stdout) -> None:
    s = res.summary
    out.write(". PhyREX-equivalent joint phylogeography summary\n")
    for k in ("n_iter", "posterior_final", "lnL_final", "root_height",
              "sigma2", "clock_rate"):
        out.write(f"  {k:18s} {s[k]}\n")
    out.write(f"  root location:     {s['root_location']}\n")


def _run_phyrex_slfv(engine, model, params, coords, time_tree,
                     settings, trace_path, verbose,
                     spatial_dist: str = "euclidean") -> PhyrexResult:
    """SLFV-mode PhyREX: SLFVJointSampler over the augmented
    event-disk state, coupled to the sequence likelihood through a
    strict clock (≙ phyrex.c:1234 with mmod->model_id ==
    SLFV_GAUSSIAN, the reference default)."""
    from phyml_tpu_torch.bayes.slfv import (
        SLFVJointSampler, SLFVParams, make_seq_loglik_fn,
        state_from_timetree, state_to_timetree,
    )

    coords = np.asarray(coords, dtype=np.float64)
    pad = 0.25 * (coords.max(0) - coords.min(0) + 1.0)
    rad0 = float(np.mean(coords.std(0)) + 0.1)
    if spatial_dist == "greatcircle":
        rad0 *= 111.0        # degrees -> km scale for the hit kernel
    p0 = SLFVParams(
        lbda=1.0, mu=0.5, rad=rad0,
        lim_lo=tuple(coords.min(0) - pad),
        lim_up=tuple(coords.max(0) + pad),
        dist_type=spatial_dist,
    )
    rng = np.random.default_rng((settings.seed if settings else 0)
                                + 4711)
    st0 = state_from_timetree(time_tree, coords, rng)
    seq_fn = make_seq_loglik_fn(engine, params)
    smp = SLFVJointSampler(
        st0, p0, seed=(settings.seed if settings else 0),
        seq_fn=seq_fn, clock0=1.0)
    s = settings or MCMCSettings()
    n_sweeps = max(50, s.n_iter // 20)
    thin = max(1, n_sweeps // 200)
    fh = open(trace_path, "w") if trace_path else None
    if fh:
        fh.write("sweep\tposterior\tlbda\tmu\trad\tn_disks\t"
                 "root_height\tclock\n")
    out = []
    for it in range(n_sweeps):
        smp.sweep()
        if it % thin == 0:
            st, p = smp.state, smp.params
            row = (smp.lp, p.lbda, p.mu, p.rad, st.n_disks,
                   float(st.h_node.max()), smp.clock)
            out.append(row)
            if fh:
                fh.write(f"{it}\t" + "\t".join(
                    f"{x:.6g}" for x in row) + "\n")
            if verbose and it % (thin * 10) == 0:
                print(f"  slfv sweep {it}/{n_sweeps} "
                      f"posterior={smp.lp:.2f} "
                      f"disks={st.n_disks}")
    if fh:
        fh.close()
    trace = np.asarray(out)
    final = smp.state
    tree, node_of = state_to_timetree(final, return_node_map=True)
    tree = TimeTree(n_otu=tree.n_otu, child=tree.child,
                    heights=tree.heights,
                    names=list(time_tree.names))
    root_ldsk = int(np.argmax(final.parent < 0))
    # sampled ancestral locations straight off the augmented state
    # (≙ PHYREX's sampled ldsk coordinates)
    anc = final.coord[node_of]
    anc[:tree.n_otu] = coords
    acc = np.asarray([smp.accepts[m] / max(smp.tries[m], 1)
                      for m in smp.MOVES])
    summary = {
        "n_iter": n_sweeps,
        "posterior_final": float(smp.lp),
        "lnL_final": float(smp.seq_lnl),
        "root_height": float(final.h_node.max()),
        "sigma2": float(smp.params.rad ** 2),
        "root_location": final.coord[root_ldsk].tolist(),
        "clock_rate": float(smp.clock),
        "spatial_model": "slfv",
        "lbda": smp.params.lbda,
        "mu": smp.params.mu,
        "rad": smp.params.rad,
        "n_disks_final": int(final.n_disks),
        "acceptance": {m: float(a)
                       for m, a in zip(smp.MOVES, acc)},
    }
    return PhyrexResult(tree=tree, state=final, trace=trace,
                        acc_rate=acc,
                        sigma2=float(smp.params.rad ** 2),
                        anc_locations=anc, summary=summary, sampler=smp)
