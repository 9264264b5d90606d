"""Carry state across from phyml_tpu (the JAX package).

The port's tests build inputs once and hand them to both packages;
these helpers turn phyml_tpu's numpy-converted parameters and tree
arrays into the port's tensors, so both compute from identical state:

    params = params_from_numpy({k: np.asarray(v)
                                for k, v in jax_params.items()})
    tree = tree_arrays_from_numpy(np.asarray(jax_tree.child),
                                  np.asarray(jax_tree.blen), device="cpu")
"""

from __future__ import annotations

import numpy as np
import torch

from phyml_tpu_torch.ops.likelihood import TreeArrays, default_device


def params_from_numpy(params: dict[str, np.ndarray], device="cpu",
                      dtype=torch.float64) -> dict[str, torch.Tensor]:
    """Model parameters as tensors (the port keeps them as host
    float64 tensors, the defaults): every key as it comes, the
    covarion model's cov_delta, cov_alpha, cov_h_fq_raw and
    cov_multipl_raw among them."""
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in params.items()}


def tree_arrays_from_numpy(child: np.ndarray, blen: np.ndarray,
                           device=None,
                           dtype=torch.float32) -> TreeArrays:
    """TreeArrays from a postorder child table [n_int, 2] and the
    per-node branch lengths [n_nodes] (phyml_tpu's TreeArrays), the
    lengths on `device` (the CUDA device unless given)."""
    return TreeArrays(
        child=torch.as_tensor(np.asarray(child, dtype=np.int32)),
        blen=torch.as_tensor(np.asarray(blen), dtype=dtype,
                             device=default_device(device)))


def chain_state_from_numpy(state: dict):
    """The port's ChainState from phyml_tpu's, given as a dict of numpy
    arrays (`{k: np.asarray(v) for k, v in jax_state._asdict().items()}`,
    the dict fields `hyper` and `subst` as dicts of arrays): float64
    host tensors, the child table int32, the parent vector int64."""
    from phyml_tpu_torch.bayes.mcmc import ChainState

    f64 = lambda v: torch.as_tensor(np.array(v, dtype=np.float64))
    out = {}
    for name in ChainState._fields:
        v = state[name]
        if name == "child":
            out[name] = torch.as_tensor(np.array(v, dtype=np.int32))
        elif name == "parent":
            out[name] = torch.as_tensor(np.array(v, dtype=np.int64))
        elif isinstance(v, dict):
            out[name] = {k: f64(x) for k, x in v.items()}
        else:
            out[name] = f64(v)
    return ChainState(**out)


def slfv_state_from_numpy(state: dict):
    """The port's SLFVState from phyml_tpu's numpy fields (`{f:
    getattr(jax_state, f) for f in (...)}` or `vars(jax_state)`): float64
    coordinates, heights and centers, int64 parent and hit ids."""
    from phyml_tpu_torch.bayes.slfv import SLFVState

    f64 = lambda v: np.array(v, dtype=np.float64)
    i64 = lambda v: np.array(v, dtype=np.int64)
    return SLFVState(n_otu=int(state["n_otu"]), coord=f64(state["coord"]),
                     h_node=f64(state["h_node"]), parent=i64(state["parent"]),
                     h_disk=f64(state["h_disk"]), centr=f64(state["centr"]),
                     hit=i64(state["hit"]))


def slfv_params_from_numpy(params: dict):
    """The port's SLFVParams from phyml_tpu's fields (`vars(jax_params)`)."""
    from phyml_tpu_torch.bayes.slfv import SLFVParams

    return SLFVParams(lbda=float(params["lbda"]), mu=float(params["mu"]),
                      rad=float(params["rad"]),
                      lim_lo=tuple(float(x) for x in params["lim_lo"]),
                      lim_up=tuple(float(x) for x in params["lim_up"]),
                      dist_type=str(params["dist_type"]))
