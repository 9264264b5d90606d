"""Distributed bootstrap farming (the mpi_boot.c replacement).

PyTorch port of phyml_tpu/parallel/boot.py.  Reference flow
(mpi_boot.c:27 Bootstrap_MPI): every MPI rank runs the full replicate
pipeline for replicates r, r+P, r+2P... with per-rank seeds
(srand(seed+rank), main.c:84); replicate tree strings travel to rank 0
and the per-edge bipartition counts reduce with MPI_Reduce(SUM)
(mpi_boot.c:335-342).

Here the ranks come from torch.distributed (the environment `torchrun`
sets, or an init_method).  Replicates are round-robin over ranks with
per-REPLICATE seeds, so the counts are bit-identical whatever the
farming layout; the count reduction is one all_reduce of a dense
per-edge vector, and no strings cross the wire.  In one process this
is the serial loop and returns identical counts.

One deliberate difference from phyml_tpu: a failed initialisation
raises (phyml_tpu swallows it and runs alone, boot.py:42-46): a run
told to farm must not quietly run on one rank.
"""

from __future__ import annotations

import datetime
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from phyml_tpu_torch.parallel.mesh import collective_device

# a rank waits this long at a collective for the others (init_process_group
# timeout): the farmed replicates differ by at most one per rank, so a
# rank that lags by more is lost
TIMEOUT_S = 1800


def replicate_shard(n_replicates: int, process_index: int,
                    process_count: int) -> list[int]:
    """Round-robin replicate ids for one process
    (mpi_boot.c:106-117: rank r handles r, r+P, r+2P, ...)."""
    return list(range(process_index, n_replicates, process_count))


def choose_backend(local_world_size: int, on_card: bool) -> str:
    """NCCL when every rank of this host has a card of its own, else
    gloo (ranks sharing a card, which NCCL refuses, and the CPU)."""
    if on_card and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(init_method: str | None = None,
                           rank: int | None = None,
                           world_size: int | None = None,
                           on_card: bool = True,
                           timeout_s: float = TIMEOUT_S) -> tuple[int, int]:
    """Join the process group: from `init_method` with rank and
    world_size, or from the environment `torchrun` sets (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/MASTER_PORT).
    Returns (rank, world size): (0, 1) without a distributed
    environment, creating no group; a group already initialised is
    used as it is.  On the card each rank takes device LOCAL_RANK
    modulo the host's cards.  A failed initialisation raises."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if init_method is None and "WORLD_SIZE" not in env:
        return 0, 1
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None \
        else world_size
    on_card = on_card and torch.cuda.is_available()
    local_rank = int(env.get("LOCAL_RANK", rank))
    backend = choose_backend(int(env.get("LOCAL_WORLD_SIZE", world_size)),
                             on_card)
    if on_card:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world_size


def process_layout() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def tree_digest(topo) -> bytes:
    """SHA-256 of a topology's (bipartition, edge id) pairs: two ranks
    whose counts may be summed by edge id hold equal digests."""
    pairs = sorted((sorted(bip), eid)
                   for bip, eid in topo.bipartitions().items())
    return hashlib.sha256(repr(pairs).encode()).digest()


def check_same_tree(topo) -> None:
    """Raise unless every rank holds the same tree (tree_digest),
    naming the ranks whose tree differs from rank 0's."""
    world = process_layout()[1]
    if world == 1:
        return
    mine = torch.tensor(list(tree_digest(topo)), dtype=torch.uint8,
                        device=collective_device())
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    differ = [r for r in range(world) if not torch.equal(every[r], every[0])]
    if differ:
        raise RuntimeError(
            f"ranks {differ} hold another final tree than rank 0: their "
            "bootstrap counts cannot be summed by edge id")


def run_bootstrap_distributed(
    engine,
    model,
    params,
    best_topo,
    n_replicates: int = 100,
    search: str = "nni",
    seed: int = 0,
    bayesian: bool = False,
    tbe: bool = False,
    verbose: bool = False,
):
    """Bootstrap supports with replicates farmed over the ranks.

    Every rank calls this with identical arguments (SPMD, like the
    reference's phyml-mpi binary) and the same best_topo (checked,
    check_same_tree); the returned {edge id: support} dict is identical
    on every rank.
    """
    from phyml_tpu_torch.search.support import bootstrap_supports

    rank, world = process_layout()
    check_same_tree(best_topo)
    mine = replicate_shard(n_replicates, rank, world)
    counts = bootstrap_supports(
        engine, model, params, best_topo,
        n_replicates=n_replicates, search=search, seed=seed,
        bayesian=bayesian, tbe=tbe,
        verbose=verbose and rank == 0,
        replicate_indices=mine,
    )
    eids = sorted(counts.keys())
    local = np.asarray([counts[e] for e in eids], dtype=np.float64)
    total = _sum_across_processes(local)
    return {e: float(c) / n_replicates for e, c in zip(eids, total)}


def _sum_across_processes(local: np.ndarray) -> np.ndarray:
    """Global SUM of a small per-edge count vector across the ranks
    (≙ MPI_Reduce(..., MPI_SUM, 0) mpi_boot.c:335, but all_reduce, so
    every rank holds the result); the identity in one process."""
    if process_layout()[1] == 1:
        return local
    x = torch.as_tensor(local, dtype=torch.float64,
                        device=collective_device())
    dist.all_reduce(x)
    return x.cpu().numpy()
