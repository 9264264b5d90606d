"""Checkpoint / resume of long analyses.

Port of phyml_tpu/utils/checkpoint.py's `Checkpointer` (the reference's
checkpoint.c is an empty stub, checkpoint.c:4-8).  State captured:
topology (edge list + branch lengths), model parameters, progress
stage and any JSON side state, written atomically (tmp + rename) as a
single .npz under the same keys as phyml_tpu's, so a file written by
either package resumes in the other.  Parameters come back as float64
host tensors, the port's parameter convention.

`save_chain` / `load_chain` do the same for an MCMC chain (phyml_tpu's
keys for the state arrays); its random stream is the port's own, so a
chain checkpoint resumes in the package that wrote it.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


class Checkpointer:
    def __init__(self, path: str, every_s: float = 300.0):
        self.path = path
        self.every_s = every_s
        self._last = 0.0

    def save(self, topo, params, stage: str, extra: dict | None = None,
             force: bool = False) -> bool:
        now = time.monotonic()
        if not force and now - self._last < self.every_s:
            return False
        self._last = now
        payload = {
            "edges": np.asarray(topo.edges),
            "blen": np.asarray(topo.blen),
            "n_otu": np.asarray(topo.n_otu),
            "stage": np.asarray(stage),
        }
        for k, v in params.items():
            payload[f"param_{k}"] = torch.as_tensor(v).detach().cpu() \
                .double().numpy()
        if extra:
            payload["extra"] = np.asarray(json.dumps(extra))
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, self.path)
        return True

    def resume(self):
        """(topo, params, stage) or None if no checkpoint exists."""
        if not os.path.exists(self.path):
            return None
        from phyml_tpu_torch.topology import Topology

        z = np.load(self.path, allow_pickle=False)
        topo = Topology(int(z["n_otu"]), z["edges"], z["blen"])
        params = {
            k[len("param_"):]: torch.as_tensor(z[k], dtype=torch.float64)
            for k in z.files if k.startswith("param_")
        }
        stage = str(z["stage"])
        return topo, params, stage

    def extra(self) -> dict:
        if not os.path.exists(self.path):
            return {}
        z = np.load(self.path, allow_pickle=False)
        if "extra" in z.files:
            return json.loads(str(z["extra"]))
        return {}


# ----------------------------------------------------------------------
# MCMC chain checkpointing (green-field; the reference has none)
# ----------------------------------------------------------------------

def save_chain(path: str, state, done: int, step_sizes, generator_state,
               extra: dict | None = None) -> None:
    """Atomically persist an MCMC ChainState + progress so a killed
    chain resumes mid-run: all state arrays (incl. the sampled
    topology) under phyml_tpu's keys (`field_<name>`, and
    `dict_<name>__<key>` with `dictkeys_<name>` for the dict fields),
    the iteration count, the tuned step sizes, and the state of the
    chain's torch.Generator (`torch_generator`).  phyml_tpu keeps a JAX
    PRNG key instead (`key`), and the two streams differ, so a chain
    checkpoint resumes in the package that wrote it.  `extra` is any
    JSON-serializable side state (the host topology-proposal RNG's
    bit-generator state and move counters)."""
    host = lambda v: torch.as_tensor(v).detach().cpu().numpy()
    payload = {"done": np.asarray(done),
               "step_sizes": np.asarray(step_sizes),
               "torch_generator": host(generator_state)}
    if extra is not None:
        payload["extra_json"] = np.asarray(json.dumps(extra))
    for field_name, v in state._asdict().items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                payload[f"dict_{field_name}__{k2}"] = host(v2)
            payload[f"dictkeys_{field_name}"] = np.asarray(
                ",".join(v.keys()))
        else:
            payload[f"field_{field_name}"] = host(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)


def load_chain(path: str, state_cls):
    """(state, done, step_sizes, generator state, extra) or None if
    absent; the state's tensors on the host (float64 scalars, int32
    tables).

    Raises ValueError on a format mismatch: a ChainState field with no
    entry in the npz (a checkpoint written before a field was added),
    or a checkpoint without a torch.Generator state (one phyml_tpu
    wrote: its JAX key cannot seed this package's stream)."""
    if not os.path.exists(path):
        return None
    z = np.load(path, allow_pickle=False)
    if "torch_generator" not in z.files:
        raise ValueError(
            f"checkpoint {path!r} holds no torch.Generator state (a "
            f"chain phyml_tpu wrote resumes in phyml_tpu only)")
    fields = {}
    missing = []
    for name in state_cls._fields:
        fk = f"field_{name}"
        dk = f"dictkeys_{name}"
        if fk in z.files:
            fields[name] = torch.as_tensor(z[fk])
        elif dk in z.files:
            keys = [k for k in str(z[dk]).split(",") if k]
            fields[name] = {
                k: torch.as_tensor(z[f"dict_{name}__{k}"]) for k in keys
            }
        else:
            missing.append(name)
    if missing:
        raise ValueError(
            f"checkpoint {path!r} lacks ChainState field(s) "
            f"{missing}: written by an older format — delete it to "
            f"start fresh")
    extra = (json.loads(str(z["extra_json"]))
             if "extra_json" in z.files else {})
    return (state_cls(**fields), int(z["done"]),
            np.asarray(z["step_sizes"]),
            torch.as_tensor(z["torch_generator"]), extra)
