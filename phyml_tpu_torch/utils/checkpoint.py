"""Checkpoint / resume of long analyses.

Port of phyml_tpu/utils/checkpoint.py's `Checkpointer` (the reference's
checkpoint.c is an empty stub, checkpoint.c:4-8).  State captured:
topology (edge list + branch lengths), model parameters, progress
stage and any JSON side state, written atomically (tmp + rename) as a
single .npz under the same keys as phyml_tpu's, so a file written by
either package resumes in the other.  Parameters come back as float64
host tensors, the port's parameter convention.
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
