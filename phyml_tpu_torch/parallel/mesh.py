"""The (boot, sites) layout of the world's ranks, on torch.distributed.

PyTorch port of phyml_tpu/parallel/mesh.py.  It replaces the
reference's MPI layer (mpi_boot.c: Bcast/Ssend/Recv/Reduce of strings
and count vectors between ranks).  As in phyml_tpu:

  * a 2-level mesh ("boot", "sites"): bootstrap replicates ride the
    outer axis, site patterns the inner one; rank = b * n_sites + s,
    as phyml_tpu's reshape of its device list;
  * a sharded engine holds one contiguous, equal slice of the
    (padded) pattern axis on each sites-rank; the per-site terms stay
    local and every weighted sum over the patterns is one all_reduce
    over the sites group (LikelihoodEngine._sum_sites).

phyml_tpu gets the collectives from XLA's SPMD partitioner; here they
are written out: every rank calls every collective of its groups in
the same order, which the engine's host loops keep by deciding only on
reduced (hence equal) values.  Collective tensors live where the
backend needs them: on the card for NCCL, on the host for gloo.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

# patterns pad to a multiple of this per sites-rank (phyml_tpu pads to
# pattern_pad = 128 * n_shards, parallel/mesh.py:80-86)
PATTERN_QUANTUM = 128


def collective_device(group=None) -> torch.device:
    """Where a collective's tensors live: the card for NCCL, the host
    for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """The world's ranks laid out as [n_boot, n_sites].  `groups` maps
    an axis to the process group of this rank's line along it (None
    where the axis has one rank: its collectives are the identity)."""

    def __init__(self, n_boot: int, n_sites: int, rank: int = 0,
                 groups: dict | None = None):
        self.shape = {"boot": n_boot, "sites": n_sites}
        self.coords = {"boot": rank // n_sites, "sites": rank % n_sites}
        self.groups = groups or {"boot": None, "sites": None}

    def _comm(self, x: torch.Tensor, axis: str):
        """(group, a copy of x on the device its backend reduces on)."""
        group = self.groups[axis]
        return group, x.detach().to(collective_device(group),
                                    copy=True).contiguous()

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of x over the ranks of this rank's line along `axis`,
        on x's device."""
        if self.groups[axis] is None:
            return x
        group, y = self._comm(x, axis)
        dist.all_reduce(y, group=group)
        return y.to(x.device)

    def all_gather(self, x: torch.Tensor, axis: str) -> list:
        """Every rank's x (equal shapes) along `axis`, in rank order, on
        x's device."""
        if self.groups[axis] is None:
            return [x]
        group, y = self._comm(x, axis)
        out = [torch.empty_like(y) for _ in range(self.shape[axis])]
        dist.all_gather(out, y, group=group)
        return [o.to(x.device) for o in out]


def make_mesh(n_boot: int = 1, n_sites: int | None = None) -> Mesh:
    """Mesh over (boot, sites) of the world's ranks (one rank when no
    process group is initialised).  Defaults: every rank on the sites
    axis.  Every rank must call it, in the same order as its other
    group creations: it creates one group per row and per column."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_sites is None:
        n_sites = world // n_boot
    if n_boot * n_sites != world:
        raise ValueError(f"{n_boot} x {n_sites} != {world} ranks")
    lines = {"sites": [[b * n_sites + s for s in range(n_sites)]
                       for b in range(n_boot)],
             "boot": [[b * n_sites + s for b in range(n_boot)]
                      for s in range(n_sites)]}
    groups = {}
    for axis in ("sites", "boot"):
        groups[axis] = None
        if len(lines[axis][0]) == 1:
            continue
        for ranks in lines[axis]:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(n_boot, n_sites, rank, groups)


def padded_pattern_count(n_patterns: int, n_shards: int) -> int:
    """Patterns padded to a multiple of PATTERN_QUANTUM * n_shards.  One
    more quantum where a shard would hold exactly n_patterns: a rank's
    slice then never has the alignment's length, which is how
    LikelihoodEngine._w tells global weights from local ones."""
    q = PATTERN_QUANTUM * n_shards
    padded = max(q, math.ceil(n_patterns / q) * q)
    if n_shards > 1 and padded // n_shards == n_patterns:
        padded += q
    return padded


def pattern_sharding(mesh: Mesh, n_padded: int, axis: str = "sites"):
    """The slice of the padded pattern axis this rank holds: one
    contiguous, equal block per rank of `axis`."""
    n = mesh.shape[axis]
    if n_padded % n:
        raise ValueError(f"{n_padded} patterns do not split over {n} ranks")
    step = n_padded // n
    i = mesh.coords[axis]
    return slice(i * step, (i + 1) * step)


def boot_sharding(mesh: Mesh, n_rows: int):
    """The slice of a replicate-weight matrix's rows [R, P] this rank's
    boot group holds: blocks of ceil(R / n_boot) rows (its columns split
    over the sites axis, pattern_sharding)."""
    step = -(-n_rows // mesh.shape["boot"])
    b = mesh.coords["boot"]
    return slice(min(b * step, n_rows), min((b + 1) * step, n_rows))


def shard_pattern_arrays(engine, mesh: Mesh, axis: str = "sites"):
    """Keep only this rank's slice of the engine's pattern-axis arrays
    (tips, weights, invar_state, invar_ok), the pattern axis padded with
    zero-weight patterns to padded_pattern_count, and attach the mesh."""
    n_padded = padded_pattern_count(engine.n_patterns, mesh.shape[axis])
    return engine.attach_mesh(mesh, axis, n_padded,
                              pattern_sharding(mesh, n_padded, axis))


def sharded_engine(aln, model, mesh: Mesh, dtype=None, axis: str = "sites",
                   device=None):
    """A LikelihoodEngine whose pattern axis is sharded over `axis` of
    `mesh` (every rank of the mesh builds it).  Its single pass runs K3
    at B = 1 on this rank's shard (phyml_tpu runs its dense kernel per
    shard under shard_map, likelihood.py:766-799); its entry points take
    and return what an unsharded engine's do."""
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine

    eng = LikelihoodEngine(aln, model, dtype=dtype or torch.float32,
                           device=device)
    return shard_pattern_arrays(eng, mesh, axis)
