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
    float64 tensors, the defaults)."""
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
