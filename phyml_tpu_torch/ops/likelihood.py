"""The likelihood engine: Felsenstein pruning on one device.

PyTorch port of phyml_tpu/ops/likelihood.py (the reference's hot core:
lk.c:443 Lk, lk.c:1659 Core_Default_Update_Partial_Lk, the SIMD
kernels avx.c/sse.c).  Design:

  * Topology is data: a postorder child table (int32 [n_int, 2]) and
    a branch-length vector indexed by rooted node.  The child table
    stays on the host (it comes from topology.RootedView), so the
    slot kernel's schedule is built from it directly; device copies
    are cached per topology.
  * Each entry point maps to a kernel:
      - host `loglik` / `site_logliks`, and `_loglik_sys` with one
        system (the branch-length probes) -> K1, or K4 when streamed
        (ops/clv_slots.py), one pass for one parameter set; K3 at B = 1
        where K4's block does not fit (`single_pass_kernel`), and on a
        sharded engine
      - `_loglik_sys` / `loglik_batch` with a batch of systems -> K3
        (ops/clv.py), the slot schedule batched over parameter sets
        for the line search
      - `edge_dotprods_sys`                 -> K2, or K5 when streamed
        (ops/edotp.py)
      - `loglik_mgf` (the Guindon 2012 clock's integrated P-matrices,
        models/eigen.py:pmat_mgf_gamma) -> the single-pass kernel, as
        the host lnL
      - `_loglik_sys` / `edge_dotprods_sys` on a stack of trees (child
        [R, n_int, 2], blen [R, n_nodes]; the rapid bootstrap's
        replicates under one system) -> one launch of K3 with a slot
        schedule per tree, and of K2 or K5 with a tree axis
    One rule picks the streamed pair (`kernel_route`): the tree's
    P-matrices of one class no longer fit a warp's share of an SM.
    On CUDA tensors these launch the hand-written kernels; on CPU
    tensors the kernels' plain PyTorch versions run.
  * The scan path (`_up_pass` / `_down_pass`, divide-by-max
    rescaling, a Python loop of a few tensor ops per node) is the
    independent reference unmasked (`site_logliks_scan`,
    `edge_dotprods_scan`) and, with prune masks and a leading
    candidate axis, the passes of the NNI and SPR scorers
    (search/nni.py, search/spr.py), which phyml_tpu also runs outside
    its kernels.
  * Class mixing (Gamma / FreeRate) is a leading axis; the +I
    invariant fraction mixes at the root exactly as lk.c:820-837.  All
    per-site logs accumulate in float64.
  * Model parameters are host float64 tensors; the eigensystem is
    built on the host and moved to the engine's device and dtype.

Sites (patterns) are the last axis of every array.  The engine's
device and dtype are fixed when it is built; the device is the CUDA
device unless the caller passes another (`default_device`).

A sharded engine (parallel/mesh.py:sharded_engine, `attach_mesh`)
holds one slice of the padded pattern axis per rank of the mesh's
sites axis and takes and returns what an unsharded one does: weights
are global and cut to the rank's slice inside (`_w`), lnL and edge
terms are global sums (`_sum_sites`, one all_reduce over the sites
group), `site_logliks` is the global [P] (`gather_sites`).  Its single
pass runs K3 at B = 1 on the shard, as phyml_tpu runs its dense kernel
per shard (phyml_tpu/ops/likelihood.py:476-479, 766-799).
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from phyml_tpu_torch.io.alignment import Alignment
from phyml_tpu_torch.models.eigen import mgf_rates, pmat
from phyml_tpu_torch.models.substitution import SubstModel
from phyml_tpu_torch.ops import _build, newton
from phyml_tpu_torch.ops.clv import uppass_site_lse
from phyml_tpu_torch.ops.clv_slots import (
    MAX_BLOCK_SMEM, build_slot_schedule, padded_tips, uppass_site_lse_slots,
    uppass_site_lse_slots_stream,
)
from phyml_tpu_torch.ops.clv_slots import geometry as slot_geometry
from phyml_tpu_torch.ops.edotp import edge_dotprods, edge_dotprods_stream
from phyml_tpu_torch.utils.trace import traced

# K1 holds each class's P-matrices of the whole tree in its warp's
# shared memory, K4 streams each step's two through a ring; K2 and K5 are
# one body (csrc/edotp.cuh) and follow the same rule.  The limit is K1's
# shared memory per warp (ops/clv_slots.py:geometry, at the schedule's
# worst-case slot count): past 48 KiB an SM holds fewer than four such
# warps, and on an H100 K4 was as fast or faster there (PERF.md, PR 5).
RESIDENT_WARP_BYTES = 48 * 1024


def kernel_route(n_otu: int, C: int, ns: int) -> tuple[str, str]:
    """(host lnL kernel, edge-dot-product kernel) for a tree of n_otu
    taxa: ("K1", "K2") while K1's shared memory at the rung of ns (the
    state count the kernels run, `_build.rung`) fits
    RESIDENT_WARP_BYTES a warp and a block of C warps, else the streamed
    ("K4", "K5").  Past the ladder's top rung the streamed pair: no
    tree's resident matrices fit a warp there (a 3-taxon tree's four
    80-state matrices are 102 KB), and K1's and K2's entries run the
    same big bodies.  Defined for every state count, on every device."""
    if _build.is_big(_build.rung(ns)):
        return ("K4", "K5")
    n_slots = int(math.ceil(math.log2(max(n_otu, 2)))) + 1
    geo = slot_geometry(ns, C, 1, n_otu, n_slots, resident=True)
    fits = geo["warp_smem_bytes"] <= RESIDENT_WARP_BYTES and \
        C * geo["warp_smem_bytes"] + 4 * C * geo["tile"] <= MAX_BLOCK_SMEM
    return ("K1", "K2") if fits else ("K4", "K5")


def single_pass_kernel(route: str, ns: int, C: int, n_otu: int,
                       n_slots: int) -> str:
    """The kernel of one single-parameter-set pass on an n_otu-taxon
    tree whose schedule needs n_slots slots: the route's slot kernel
    (K1 or K4, kernel_route) while its block fits shared memory at that
    slot count, else K3 at B = 1.  K1's route is chosen at the worst
    slot count, so only K4 can miss: its C warps each hold a ring and
    the slots (at 20 states, 25 KB + 2.7 KB a slot a warp), so a block
    of 8 classes holds one slot only, and one of 4 classes twelve.  Past
    the ladder K4 and K3 run one big body whose block is the same, so the
    route's K4 is named (a block that does not fit refuses at launch,
    naming its shape)."""
    if _build.is_big(_build.rung(ns)):
        return route
    geo = slot_geometry(ns, C, 1, n_otu, n_slots, resident=route == "K1")
    return route if geo["block_smem_bytes"] <= MAX_BLOCK_SMEM else "K3"


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else
    the CUDA device.  Without one this raises rather than falling
    back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "phyml_tpu_torch runs on the CUDA device by default and none "
            "is available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


class TreeArrays(NamedTuple):
    """Topology + branch lengths (see topology.RootedView); a stack of
    R trees of one taxon set carries a leading axis on both."""
    child: torch.Tensor  # int32 [n_internal, 2] on the host, postorder,
    #                      last row = root
    blen: torch.Tensor   # [n_nodes] edge length to parent, on device


def tree_arrays(rv, dtype=torch.float32, device=None) -> TreeArrays:
    """TreeArrays of a RootedView, branch lengths on `device` (the
    CUDA device unless given; see default_device)."""
    return TreeArrays(
        child=torch.as_tensor(np.asarray(rv.child, dtype=np.int32)),
        blen=torch.as_tensor(np.asarray(rv.node_blen), dtype=dtype,
                             device=default_device(device)),
    )


def _param_key(params: dict):
    """Content identity of a params dict: each value's object id and
    in-place version counter (a write into a tensor bumps it)."""
    return tuple(sorted((k, id(v), getattr(v, "_version", 0))
                        for k, v in params.items()))


class LikelihoodEngine(nn.Module):
    """Likelihood programs for one (alignment, model) pair.

    Buffers: tips [n_otu, ns, P], weights float64 [P], invar_state
    int64 [P] and invar_ok [P] (1 where the pattern is constant);
    `slot_tips`, the tips as a view of row-padded storage, feeds K1/K4.
    `lnl_route` / `edotp_route` name the kernels the host lnL and the
    edge dot products run through (kernel_route).
    """

    def __init__(self, aln: Alignment, model: SubstModel,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.aln = aln
        self.model = model
        self.dtype = dtype
        self.device = default_device(device)
        self.n_otu = aln.n_otu
        # the process's state count (covarion: obs_ns x n_hidden); the
        # kernels pad it to a rung of their ladder (past its top, to a
        # multiple of 16), nothing here does
        self.ns = model.ns
        self.C = model.n_classes
        self.n_nodes = 2 * self.n_otu - 1
        self.n_internal = self.n_otu - 1
        # patterns held here (a shard's, once attach_mesh cuts them),
        # the alignment's, and the padded count the shards split
        self.P = self.n_patterns = self.n_padded = aln.n_patterns
        # Sethi-Ullman bound of the slot schedule (build_slot_schedule)
        self.slot_count = int(math.ceil(math.log2(max(self.n_otu, 2)))) + 2
        self.lnl_route, self.edotp_route = kernel_route(self.n_otu, self.C,
                                                        self.ns)
        if self.device.type == "cuda":
            # the P-matrix einsum must run in full float32: a TF32
            # P(t) is a ~1e-3 per-site likelihood error
            torch.backends.cuda.matmul.allow_tf32 = False

        dev = dict(device=self.device)
        tips = np.transpose(aln.partials, (0, 2, 1))  # [n_otu, obs_ns, P]
        if self.ns != tips.shape[1]:
            # covarion: the observed-state tip vector for every hidden
            # class (M4_Init_Partial_Lk_Tips m4.c:528; states h * n_o + o)
            tips = np.tile(tips, (1, self.ns // tips.shape[1], 1))
        tips = np.ascontiguousarray(tips)
        self.register_buffer("tips", torch.as_tensor(tips, dtype=dtype,
                                                     **dev))
        # the slot kernels' (K1, K4) view of the tips, rows padded to
        # their pattern tile
        self.register_buffer("slot_tips", padded_tips(self.tips))
        self.register_buffer("weights", torch.as_tensor(
            aln.weights, dtype=torch.float64, **dev))
        inv = np.asarray(aln.invariant)
        self.register_buffer("invar_state", torch.as_tensor(
            np.maximum(inv, 0), dtype=torch.long, **dev))
        self.register_buffer("invar_ok", torch.as_tensor(
            inv >= 0, dtype=dtype, **dev))
        self._tiny = torch.finfo(dtype).tiny

        # caches: the eigensystem of the last params dict, P-matrices
        # per (system, branch lengths), device topology per child table
        self._sys_cache = None
        self._pm_cache: collections.OrderedDict = collections.OrderedDict()
        self._topo_cache: collections.OrderedDict = \
            collections.OrderedDict()
        # the mesh of a sharded engine (attach_mesh), else None
        self._mesh = None
        self._shard_axis = None
        self._cols = slice(None)

    def attach_mesh(self, mesh, axis: str, n_padded: int, cols: slice):
        """Shard the pattern axis over `axis` of `mesh`: pad it to
        n_padded with zero-weight patterns (tips 1, not invariant) and
        keep the columns `cols` of tips, weights, invar_state and
        invar_ok (parallel/mesh.py:shard_pattern_arrays).  Returns the
        engine."""
        self._mesh, self._shard_axis = mesh, axis
        self.n_padded, self._cols = n_padded, cols
        for name, fill in (("tips", 1.0), ("weights", 0.0),
                           ("invar_state", 0), ("invar_ok", 0.0)):
            setattr(self, name, self._columns(getattr(self, name), fill))
        self.register_buffer("slot_tips", padded_tips(self.tips))
        self.P = self.tips.shape[-1]
        self._pm_cache.clear()
        return self

    def _columns(self, x, fill=0.0):
        """This rank's columns of a global array [..., n_patterns] (or
        already padded, [..., n_padded]), padded with `fill`."""
        x = torch.as_tensor(x, device=self.device)
        if x.shape[-1] not in (self.n_patterns, self.n_padded):
            raise ValueError(f"{x.shape[-1]} patterns: expected "
                             f"{self.n_patterns} or {self.n_padded}")
        pad = self.n_padded - x.shape[-1]
        if pad:
            x = torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], -1)
        return x[..., self._cols].contiguous()

    def _w(self, weights):
        """The pattern weights an entry point applies: the engine's own
        when None.  On a sharded engine, weights of the global length
        (the alignment's, or padded) are cut to this rank's columns;
        weights of the local length pass as they are (no global length
        equals it, parallel/mesh.py:padded_pattern_count)."""
        if weights is None:
            return self.weights
        if self._mesh is None or weights.shape[-1] == self.P:
            return weights
        return self._columns(weights)

    def _sum_sites(self, *sums):
        """Complete per-rank sums over the pattern axis: the identity on
        an unsharded engine; on a sharded one, one all_reduce over the
        sites group for all of them (equal shapes).  Every weighted sum
        over the patterns goes through here."""
        if self._mesh is not None:
            sums = self._mesh.all_reduce(torch.stack(sums),
                                         self._shard_axis).unbind(0)
        return sums[0] if len(sums) == 1 else tuple(sums)

    def gather_sites(self, x):
        """A per-pattern array [..., P] of every rank's shard, joined
        into the global [..., n_patterns] (the padding dropped); the
        identity on an unsharded engine."""
        if self._mesh is None:
            return x
        parts = self._mesh.all_gather(x, self._shard_axis)
        return torch.cat(parts, dim=-1)[..., :self.n_patterns]

    # ------------------------------------------------------------------
    # model plumbing
    # ------------------------------------------------------------------
    def system_of(self, params):
        """Device-resident (lam, V, Vinv, pi, w, pinv), cached by the
        content identity of the params dict (see _param_key).  Callers
        replace parameter tensors rather than writing into them; a
        write in place bumps the tensor's version and misses the
        cache."""
        key = _param_key(params)
        hit = self._sys_cache
        if hit is not None and hit[0] == key:
            return hit[2]
        sys = self._system(params)
        # strong refs to the values keep their ids from being reused
        self._sys_cache = (key, list(params.values()), sys)
        return sys

    def _system(self, params, dtype=None):
        """Eigensystem of params (batched when the params are; see
        SubstModel.class_system), on the engine's device, in its dtype
        unless `dtype` is given."""
        params = {k: torch.as_tensor(v).detach().to("cpu", torch.float64)
                  for k, v in params.items()}
        lam, V, Vinv, pi, w, pinv = self.model.class_system(params)
        if "il_sigma" in params:
            # Integrated-length (IL) model (reference --il,
            # gamma_mgf_bl cl.c:430-434): each branch length is
            # Gamma-distributed with mean t and variance t*sigma, and
            # E[P(L)] = V diag(exp(t*mu)) V^-1 with
            # mu = -log(1-lam*sigma)/sigma — an exponential family in
            # t again, so substituting mu for lam makes every path
            # exact under IL.
            sig = torch.exp(params["il_sigma"])[..., None, None]
            lam_il = -torch.log(torch.clamp(1.0 - lam * sig, min=1e-30)) \
                / torch.clamp(sig, min=1e-30)
            lam = torch.where(sig > 1e-12, lam_il, lam)
        return tuple(x.to(self.device, dtype or self.dtype).contiguous()
                     for x in (lam, V, Vinv, pi, w, pinv))

    @traced("engine.pmats")
    def _pmats(self, lam, V, Vinv, blen):
        """P [..., n_nodes, C, ns, ns]; class rates are folded into
        lam, whose leading batch shape (if any) leads the result, or
        that of blen [R, n_nodes] for a stack of trees."""
        t = blen.to(self.dtype)[..., None].expand(*blen.shape, self.C)
        return pmat(lam, V, Vinv, t).contiguous()

    def _pmats_cached(self, sys, tree):
        """P-matrices for host entry points, cached per (system,
        branch lengths): repeated evaluations of the same tree skip
        the P-matrix build."""
        key = (id(sys), id(tree.blen), tree.blen._version)
        hit = self._pm_cache.get(key)
        if hit is not None:
            self._pm_cache.move_to_end(key)
            return hit[2]
        lam, V, Vinv = sys[:3]
        pm = self._pmats(lam, V, Vinv, tree.blen)
        # strong refs to sys and blen keep their ids from being reused
        self._pm_cache[key] = (sys, tree.blen, pm)
        while len(self._pm_cache) > 32:
            self._pm_cache.popitem(last=False)
        return pm

    def _topology(self, child):
        """(device child table, device slot schedule, the schedule's
        slot count) for a host child table, cached by its bytes.  A
        stack of tables [R, n_int, 2] gives the stacked tables and
        schedules [R, n_int, 7] and the largest of their slot counts."""
        host = np.ascontiguousarray(np.asarray(child, dtype=np.int32))
        key = (host.shape, host.tobytes())
        hit = self._topo_cache.get(key)
        if hit is not None:
            self._topo_cache.move_to_end(key)
            return hit
        if host.ndim == 3:
            per = [self._topology(c) for c in host]
            hit = (torch.stack([h[0] for h in per]),
                   torch.stack([h[1] for h in per]),
                   max(h[2] for h in per))
        else:
            sched, n_slots = build_slot_schedule(self.n_otu, host)
            assert n_slots <= self.slot_count, (n_slots, self.slot_count)
            hit = (torch.as_tensor(host, device=self.device),
                   torch.as_tensor(sched, device=self.device), n_slots)
        self._topo_cache[key] = hit
        while len(self._topo_cache) > 1024:
            self._topo_cache.popitem(last=False)
        return hit

    def _logw(self, w):
        return torch.log(torch.clamp(w, min=self._tiny))

    # ------------------------------------------------------------------
    # one parameter set: K1 (slot kernel) or K4 (streamed), else K3 at B=1
    # ------------------------------------------------------------------
    def _slot_site_lse(self, tree, pm, pi, w):
        """The variable-rate site lse [P] of one parameter set through
        the kernel single_pass_kernel names, on the schedule's own slot
        count; K3 at B = 1 on a sharded engine."""
        child, sched, n_slots = self._topology(tree.child)
        logw = self._logw(w)
        kernel = "K3" if self._mesh is not None else single_pass_kernel(
            self.lnl_route, self.ns, self.C, self.n_otu, n_slots)
        if kernel == "K3":
            return uppass_site_lse(child, self.tips, pm[None], pi[None],
                                   logw[None], sched=sched,
                                   n_slots=n_slots)[0]
        slots = uppass_site_lse_slots if kernel == "K1" \
            else uppass_site_lse_slots_stream
        return slots(sched, self.slot_tips, pm, pi, logw, n_slots=n_slots)

    def _site_logliks_slots(self, sys, tree):
        lam, V, Vinv, pi, w, pinv = sys
        lse = self._slot_site_lse(tree, self._pmats_cached(sys, tree), pi,
                                  w)
        return self._mix_invar(lse.to(self.dtype), pi, w, pinv)

    def loglik(self, params, tree: TreeArrays, weights=None):
        """Weighted lnL (float64 0-d tensor on the engine's device)."""
        site = self._site_logliks_slots(self.system_of(params), tree)
        return self._sum_sites(torch.sum(site.double() * self._w(weights)))

    def site_logliks(self, params, tree: TreeArrays):
        return self.gather_sites(
            self._site_logliks_slots(self.system_of(params), tree))

    # ------------------------------------------------------------------
    # systems: one (K1/K4) or a batch (K3, batched over systems)
    # ------------------------------------------------------------------
    def _site_logliks_sys(self, sys, tree: TreeArrays):
        """Site log-likelihoods [..., P] for a system whose leading
        batch shape (none, or [B]) is carried through one launch: one
        system through the route's slot kernel, a batch through K3.  A
        stack of R trees under one system gives [R, P], through one K3
        launch with a slot schedule per tree."""
        lam, V, Vinv, pi, w, pinv = sys
        if tree.child.dim() == 3 and lam.dim() != 2:
            raise ValueError("a stack of trees takes one system")
        pm = self._pmats(lam, V, Vinv, tree.blen)
        if pm.dim() == 4:
            lse = self._slot_site_lse(tree, pm, pi, w)
        else:
            child, sched, n_slots = self._topology(tree.child)
            lse = uppass_site_lse(child, self.tips, pm, pi, self._logw(w),
                                  sched=sched, n_slots=n_slots)
        return self._mix_invar(lse.to(self.dtype), pi, w, pinv)

    def _loglik_sys(self, sys, tree: TreeArrays, weights=None):
        """Weighted lnL: 0-d for one system and tree, [B] for a batch
        of systems, [R] for a stack of trees (weights [R, P], each
        tree's own pattern weights applied after the kernel).  On a mesh
        with a boot axis, weights [R, P] are split by rows over the boot
        groups (parallel/mesh.py:boot_sharding): each sums its rows, and
        the lnL [R] is gathered over the boot axis."""
        site = self._site_logliks_sys(sys, tree)
        w = self._w(weights)
        if w.dim() == 2 and self._mesh is not None \
                and self._mesh.shape["boot"] > 1:
            return self._boot_rows_lnl(site, w)
        return self._sum_sites(torch.sum(site.double() * w, dim=-1))

    def _boot_rows_lnl(self, site, w):
        """lnL [R] of weights [R, P] (site [P], or [R, P] for a stack of
        trees), each boot group summing its block of rows."""
        from phyml_tpu_torch.parallel.mesh import boot_sharding

        R, n_boot = w.shape[0], self._mesh.shape["boot"]
        rows = boot_sharding(self._mesh, R)
        mine = site[rows] if site.dim() == 2 else site
        part = self._sum_sites(torch.sum(mine.double() * w[rows], dim=-1))
        step = -(-R // n_boot)
        part = torch.cat([part, part.new_zeros(step - part.shape[0])])
        return torch.cat(self._mesh.all_gather(part, "boot"))[:R]

    # lnL [B] of a batch of systems (leading axis B, from _system of
    # batched params) on one tree: batched P-matrices, then one
    # batched K3 launch
    loglik_batch = _loglik_sys

    def loglik_mgf(self, params, tree: TreeArrays, sigma, weights=None):
        """lnL with branch-length-integrated P matrices: each branch
        length is Gamma-distributed with mean blen and variance
        blen*sigma, and P is its expectation (PMat_MGF_Gamma
        models.c:1044; gamma_mgf_bl path of lk.c:2310-2323), the exact
        likelihood of the Guindon 2012 relaxed clock.  One pass through
        the route's slot kernel, as loglik."""
        return self._loglik_mgf_sys(self.system_of(params), tree, sigma,
                                    weights)

    def _loglik_mgf_sys(self, sys, tree: TreeArrays, sigma, weights=None):
        """_loglik_sys at the system whose eigenvalues are the MGF's
        (models/eigen.py:mgf_rates): its P(t) are the integrated ones."""
        lam, *rest = sys
        sig = torch.as_tensor(sigma).to(self.device, self.dtype)
        return self._loglik_sys((mgf_rates(lam, sig), *rest), tree, weights)

    # ------------------------------------------------------------------
    # scan path (independent reference; divide-by-max rescaling), and
    # the masked passes of the NNI/SPR scorers
    # ------------------------------------------------------------------
    def _scan_mask(self, mask):
        """(lead shape, device mask [..., n_internal, 2], host [n_int,
        2] bool: any candidate masks that child) of an optional mask.
        Rows no candidate masks skip the masking arithmetic, which is
        exact there (x * 1 + 0 = x)."""
        if mask is None:
            return (), None, None
        host = torch.as_tensor(mask).detach().cpu()
        rows = (host.reshape(-1, self.n_internal, 2) != 0).any(0).tolist()
        return tuple(host.shape[:-2]), host.to(self.device, self.dtype), \
            rows

    @staticmethod
    def _unit(p, s, m, lead):
        """A masked child's (partial, scale): m = 1 makes it a unit
        factor, m = 0 leaves it as it is (m [*lead])."""
        mb = m.reshape(lead + (1, 1, 1))
        return p * (1.0 - mb) + mb, s * (1.0 - m.reshape(lead + (1, 1)))

    @traced("engine.up_pass")
    def _up_pass(self, pmats, child, mask=None):
        """Inside partials: (pup, clv, sc) [*lead, n_nodes, C, ns, P] /
        [*lead, n_nodes, C, P].

        mask (optional) [*lead, n_internal, 2] in {0., 1.}: a 1 makes
        the corresponding child contribute a unit factor, i.e. the node
        behaves as if that child subtree were pruned.  Because P
        matrices of the same Q compose (P(a)P(b) = P(a+b)), the
        resulting partials are exactly those of the healed tree with
        the two link edges merged (the reference's Prune_Subtree,
        utilities.c:6152).  A leading candidate axis of the mask scores
        a block of prune candidates on one child table and one set of
        P-matrices; the node axis is stored first and moved behind the
        candidate axis in the views returned.

        A stack of trees (child [R, n_internal, 2], pmats [R, n_nodes,
        C, ns, ns]; no mask) gives [R, n_nodes, ...]: each step gathers
        every tree's own children (the rapid bootstrap's NNI scorer)."""
        if child.dim() == 3:
            return self._up_pass_stacked(pmats, child, mask)
        n, C, ns, P = self.n_otu, self.C, self.ns, self.P
        lead, md, rows = self._scan_mask(mask)
        one = (1,) * len(lead)
        pup = self.tips.new_zeros((self.n_nodes,) + lead + (C, ns, P))
        clv = torch.zeros_like(pup)
        sc = self.tips.new_zeros((self.n_nodes,) + lead + (C, P))
        tip_clv = self.tips[:, None].expand(n, C, ns, P)
        pup[:n] = torch.einsum("ncxy,ncyp->ncxp", pmats[:n],
                               tip_clv).reshape((n,) + one + (C, ns, P))
        clv[:n] = tip_clv.reshape((n,) + one + (C, ns, P))
        for i, (c0, c1) in enumerate(child.tolist()):
            u = n + i
            p0, p1, s0, s1 = pup[c0], pup[c1], sc[c0], sc[c1]
            if md is not None and rows[i][0]:
                p0, s0 = self._unit(p0, s0, md[..., i, 0], lead)
            if md is not None and rows[i][1]:
                p1, s1 = self._unit(p1, s1, md[..., i, 1], lead)
            x = p0 * p1                                  # [.., C, ns, P]
            m = torch.clamp(torch.amax(x, dim=-2, keepdim=True),
                            min=self._tiny)
            x = x / m
            sc[u] = s0 + s1 + torch.log(m[..., 0, :])
            pup[u] = torch.einsum("cxy,...cyp->...cxp", pmats[u], x)
            clv[u] = x
        k = len(lead)
        return pup.movedim(0, k), clv.movedim(0, k), sc.movedim(0, k)

    def _stack_rows(self, child, mask):
        """(device long child table [R, n_internal, 2], arange(R)) of a
        stack of trees for the stacked passes, which take no mask."""
        if mask is not None:
            raise ValueError("the stacked passes take no prune mask")
        table = self._topology(child)[0].long()
        return table, torch.arange(table.shape[0], device=self.device)

    def _up_pass_stacked(self, pmats, child, mask):
        """_up_pass of a stack of trees: node axis stored first, each
        step's children gathered per tree (row i of every tree makes
        node n_otu + i)."""
        n, C, ns, P = self.n_otu, self.C, self.ns, self.P
        table, ar = self._stack_rows(child, mask)
        R = table.shape[0]
        pup = self.tips.new_zeros((self.n_nodes, R, C, ns, P))
        clv = torch.zeros_like(pup)
        sc = self.tips.new_zeros((self.n_nodes, R, C, P))
        tip_clv = self.tips[:, None].expand(n, C, ns, P)
        pup[:n] = torch.einsum("rncxy,ncyp->nrcxp", pmats[:, :n], tip_clv)
        clv[:n] = tip_clv[:, None]
        for i in range(self.n_internal):
            u = n + i
            c0, c1 = table[:, i, 0], table[:, i, 1]
            x = pup[c0, ar] * pup[c1, ar]                # [R, C, ns, P]
            m = torch.clamp(torch.amax(x, dim=-2, keepdim=True),
                            min=self._tiny)
            x = x / m
            sc[u] = sc[c0, ar] + sc[c1, ar] + torch.log(m[..., 0, :])
            pup[u] = torch.einsum("rcxy,rcyp->rcxp", pmats[:, u], x)
            clv[u] = x
        return pup.movedim(0, 1), clv.movedim(0, 1), sc.movedim(0, 1)

    def _down_pass_stacked(self, pmats, child, pup, sc, pi, mask):
        """_down_pass of a stack of trees (pup and sc _up_pass_stacked's,
        [R, n_nodes, ...])."""
        n = self.n_otu
        table, ar = self._stack_rows(child, mask)
        pup, sc = pup.movedim(1, 0), sc.movedim(1, 0)
        out = torch.zeros_like(pup)
        sc_out = torch.zeros_like(sc)
        r0, r1 = table[:, -1, 0], table[:, -1, 1]
        pi_b = pi[:, :, None]
        out[r0, ar] = pi_b * pup[r1, ar]
        sc_out[r0, ar] = sc[r1, ar]
        out[r1, ar] = pi_b * pup[r0, ar]
        sc_out[r1, ar] = sc[r0, ar]
        for i in range(self.n_internal - 2, -1, -1):
            u = n + i
            c0, c1 = table[:, i, 0], table[:, i, 1]
            p0, p1, s0, s1 = pup[c0, ar], pup[c1, ar], sc[c0, ar], sc[c1, ar]
            grand = torch.einsum("rcwz,rcwp->rczp", pmats[:, u], out[u])
            o0 = grand * p1
            o1 = grand * p0
            m0 = torch.clamp(torch.amax(o0, dim=-2, keepdim=True),
                             min=self._tiny)
            m1 = torch.clamp(torch.amax(o1, dim=-2, keepdim=True),
                             min=self._tiny)
            out[c0, ar] = o0 / m0
            out[c1, ar] = o1 / m1
            sc_out[c0, ar] = sc_out[u] + s1 + torch.log(m0[..., 0, :])
            sc_out[c1, ar] = sc_out[u] + s0 + torch.log(m1[..., 0, :])
        return out.movedim(0, 1), sc_out.movedim(0, 1)

    @traced("engine.down_pass")
    def _down_pass(self, pmats, child, pup, sc, pi, mask=None):
        """Outside partials O[u]: the likelihood of all data outside
        subtree(u), conditional on the state at u's parent.  `mask` as
        in _up_pass (a masked child's sibling sees a unit factor in
        place of the masked subtree); pup and sc are _up_pass's.  A
        stack of trees as in _up_pass."""
        if child.dim() == 3:
            return self._down_pass_stacked(pmats, child, pup, sc, pi, mask)
        n = self.n_otu
        rows = child.tolist()
        lead, md, mrows = self._scan_mask(mask)
        k = len(lead)
        pup, sc = pup.movedim(k, 0), sc.movedim(k, 0)
        out = torch.zeros_like(pup)
        sc_out = torch.zeros_like(sc)
        r0, r1 = rows[-1]
        pi_b = pi[:, :, None]
        out[r0] = pi_b * pup[r1]
        sc_out[r0] = sc[r1]
        out[r1] = pi_b * pup[r0]
        sc_out[r1] = sc[r0]
        # reverse preorder: internal nodes except the root row
        for i in range(self.n_internal - 2, -1, -1):
            u = n + i
            c0, c1 = rows[i]
            p0, p1, s0, s1 = pup[c0], pup[c1], sc[c0], sc[c1]
            if md is not None and mrows[i][0]:
                p0, s0 = self._unit(p0, s0, md[..., i, 0], lead)
            if md is not None and mrows[i][1]:
                p1, s1 = self._unit(p1, s1, md[..., i, 1], lead)
            grand = torch.einsum("cwz,...cwp->...czp", pmats[u], out[u])
            o0 = grand * p1
            o1 = grand * p0
            m0 = torch.clamp(torch.amax(o0, dim=-2, keepdim=True),
                             min=self._tiny)
            m1 = torch.clamp(torch.amax(o1, dim=-2, keepdim=True),
                             min=self._tiny)
            out[c0] = o0 / m0
            out[c1] = o1 / m1
            sc_out[c0] = sc_out[u] + s1 + torch.log(m0[..., 0, :])
            sc_out[c1] = sc_out[u] + s0 + torch.log(m1[..., 0, :])
        return out.movedim(0, k), sc_out.movedim(0, k)

    def _root_site_loglik(self, pup, sc, pi, w, pinv):
        """log L per pattern [P], mixing classes and +I exactly as the
        reference root loop (lk.c:767-860 Lk_Core)."""
        root = self.n_nodes - 1
        lroot = torch.clamp(torch.einsum("cx,cxp->cp", pi, pup[root]),
                            min=self._tiny)
        a = torch.log(w)[:, None] + sc[root] + torch.log(lroot)
        return self._mix_invar(torch.logsumexp(a, dim=0), pi, w, pinv)

    def loglik_functional(self, sys, child, blen, weights=None):
        """Weighted lnL differentiable in blen [n_nodes] and in the
        system's tensors: the scan path (divide-by-max rescaling, as
        _up_pass) in float64 on the engine's tips and device, built of
        new tensors, with no write in place, so that torch.autograd and
        torch.func (grad, jvp, vmap) run through it.  The kernels have
        no backward pass; MALA's gradient and the fastlk Hessian come
        from here."""
        lam, V, Vinv, pi, w, pinv = sys
        pm = pmat(lam, V, Vinv, blen[:, None].expand(self.n_nodes, self.C))
        tiny = torch.finfo(torch.float64).tiny
        n = self.n_otu
        tips = self.tips.to(torch.float64)
        pup = [torch.einsum("cxy,yp->cxp", pm[u], tips[u]) for u in range(n)]
        sc = [tips.new_zeros((self.C, self.P))] * n
        for i, (c0, c1) in enumerate(torch.as_tensor(child).tolist()):
            x = pup[c0] * pup[c1]
            m = torch.clamp(torch.amax(x, dim=-2, keepdim=True), min=tiny)
            sc.append(sc[c0] + sc[c1] + torch.log(m[..., 0, :]))
            pup.append(torch.einsum("cxy,cyp->cxp", pm[n + i], x / m))
        site = self._root_site_loglik(pup, sc, pi, w, pinv)
        return self._sum_sites(torch.sum(site * self._w(weights)))

    def site_logliks_scan(self, sys, tree: TreeArrays):
        lam, V, Vinv, pi, w, pinv = sys
        pup, _, sc = self._up_pass(self._pmats(lam, V, Vinv, tree.blen),
                                   tree.child)
        return self._root_site_loglik(pup, sc, pi, w, pinv)

    def edge_dotprods_scan(self, sys, tree: TreeArrays, weights=None):
        """edge_dotprods_sys through the scan path."""
        lam, V, Vinv, pi, w, pinv = sys
        pmats = self._pmats(lam, V, Vinv, tree.blen)
        pup, clv, sc = self._up_pass(pmats, tree.child)
        out, sc_out = self._down_pass(pmats, tree.child, pup, sc, pi)
        b = torch.einsum("ciy,ncyp->ncip", Vinv, clv)
        a = torch.einsum("czi,nczp->ncip", V, out)
        return a * b, sc_out + sc, self._aux(sys, weights)

    # ------------------------------------------------------------------
    # root reduction helpers
    # ------------------------------------------------------------------
    def _inv_lk(self, pi, w):
        """Per-pattern invariant-site likelihood pi[invar_state]
        (lk.c:1240), 0 for non-invariant patterns."""
        pi_mix = torch.einsum("...c,...cx->...x", w, pi)
        if self.model.covarion:
            # invariant patterns are defined over OBSERVED states;
            # marginalize the hidden classes out of pi
            pi_mix = pi_mix.reshape(*pi_mix.shape[:-1],
                                    self.model.n_hidden, -1).sum(-2)
        return pi_mix[..., self.invar_state] * self.invar_ok

    def _mix_invar(self, lse, pi, w, pinv):
        """Fold the +I invariant fraction into the variable-rate site
        log-likelihoods (lk.c:820-837: L = (1-p) L_var + p pi[invar])."""
        if not self.model.invar:
            return lse
        pinv = pinv[..., None]
        inv_lk = self._inv_lk(pi, w)
        var_part = torch.log1p(-pinv) + lse
        inv_part = torch.log(torch.clamp(pinv * inv_lk, min=self._tiny))
        return torch.where(self.invar_ok > 0,
                           torch.logaddexp(var_part, inv_part), var_part)

    # ------------------------------------------------------------------
    # eigen-LR edge machinery (lk.c:1038 / lk.c:655, all edges at once)
    # ------------------------------------------------------------------
    def _aux(self, sys, weights):
        lam, V, Vinv, pi, w, pinv = sys
        inv_lk = self._inv_lk(pi, w) if self.model.invar else \
            self.tips.new_zeros(self.P)
        return dict(lam=lam, w=w, pinv=pinv, weights=self._w(weights),
                    inv_lk=inv_lk)

    def edge_dotprods_sys(self, sys, tree: TreeArrays, weights=None):
        """Eigen-basis dot products for every edge simultaneously:
        d [n_nodes, C, ns, P], sc_d [n_nodes, C, P] such that the
        per-(class, pattern) site likelihood as a function of edge-u's
        length alone is
            L_u(t)[c, p] = exp(sc_d[u, c, p]) * sum_i d[u,c,i,p] e^{lam[c,i] t}.
        The rows for the root and for the zero-length root child are
        meaningless and must be masked by the caller.  A stack of R
        trees (one system, weights [R, P]) gives d [R, n_nodes, C, ns,
        P] and sc_d [R, n_nodes, C, P] from one launch."""
        lam, V, Vinv, pi, w, pinv = sys
        if tree.child.dim() == 3 and lam.dim() != 2:
            raise ValueError("a stack of trees takes one system")
        child, _, _ = self._topology(tree.child)
        edotp = edge_dotprods if self.edotp_route == "K2" \
            else edge_dotprods_stream
        d, sc_d = edotp(child, self.tips,
                        self._pmats(lam, V, Vinv, tree.blen), V, Vinv, pi)
        aux = self._aux(sys, weights)
        if child.dim() == 3:
            # each tree's weights [R, 1, P] meet its nodes' site terms
            aux["weights"] = aux["weights"][:, None, :]
        return d.to(self.dtype), sc_d.to(self.dtype), aux

    def edge_site_terms(self, d_n, sc_n, aux, t):
        """Per-site (log-likelihood, dlnL, d2lnL) as a function of ONE
        edge length t, from that edge's dot products.  Shapes: site
        [..., P]."""
        lam, w, pinv = aux["lam"], aux["w"], aux["pinv"]
        inv_lk = aux["inv_lk"]
        lam_b = lam[..., :, :, None]                     # [C, ns, 1]
        t_b = torch.as_tensor(t)[..., None, None, None]  # scalar or [E]
        e = torch.exp(lam_b * t_b)
        s0 = torch.sum(d_n * e, dim=-2)                  # [..., C, P]
        s1 = torch.sum(d_n * lam_b * e, dim=-2)
        s2 = torch.sum(d_n * lam_b * lam_b * e, dim=-2)

        m = torch.amax(sc_n, dim=-2, keepdim=True)       # [..., 1, P]
        ew = w[:, None] * torch.exp(sc_n - m)            # [..., C, P]
        A0 = torch.clamp(torch.sum(ew * s0, dim=-2), min=self._tiny)
        A1 = torch.sum(ew * s1, dim=-2)
        A2 = torch.sum(ew * s2, dim=-2)
        m = m[..., 0, :]                                 # [..., P]

        one_m_p = 1.0 - pinv
        if self.model.invar:
            log_var = torch.log(one_m_p) + torch.log(A0) + m
            inv_part = torch.log(torch.clamp(pinv * inv_lk,
                                             min=self._tiny))
            site = torch.where(self.invar_ok > 0,
                               torch.logaddexp(log_var, inv_part), log_var)
        else:
            site = torch.log(A0) + m
        # d site / dt = (1-p) A1 e^{m - site}; stable in both regimes
        ratio = one_m_p * torch.exp(
            torch.log(torch.clamp(torch.abs(A1), min=self._tiny)) + m
            - site) * torch.sign(A1)
        ratio2 = one_m_p * torch.exp(
            torch.log(torch.clamp(torch.abs(A2), min=self._tiny)) + m
            - site) * torch.sign(A2)
        return site, ratio, ratio2 - ratio ** 2

    def edge_lnl_terms(self, d_n, sc_n, aux, t):
        """(lnL, dlnL, d2lnL) of the whole tree as a function of ONE
        edge length t, from that edge's dot products d_n [C, ns, P] and
        scales sc_n [C, P] (the reference's dLk, lk.c:655 +
        Br_Len_Spline Newton, optimiz.c:2244).  Broadcasts: t may be
        [n_edges] with d_n [n_edges, C, ns, P]."""
        site, dln, d2ln = self.edge_site_terms(d_n, sc_n, aux, t)
        wts = aux["weights"]
        return self._sum_sites(torch.sum(site.double() * wts, dim=-1),
                               torch.sum(dln.double() * wts, dim=-1),
                               torch.sum(d2ln.double() * wts, dim=-1))

    def newton_solve(self, d, sc, aux, t, iters, mask=None):
        """`iters` safeguarded Newton steps on every row's edge length t
        [*lead] (at most two leading axes), each row on its own curve
        edge_lnl_terms(d, sc, aux, t) with d [*lead, C, ns, P] and sc
        [*lead, C, P]; rows where `mask` (broadcast to t) is False keep
        their length.  One K6 launch on the card, the plain loop on the
        CPU (ops/newton.py)."""
        return newton.solve(self, d, sc, aux, t, iters, mask)
