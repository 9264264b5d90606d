"""Alignment container + site-pattern compression.

Parity targets in the reference:
  - Compact_Data (utilities.c:215): crunch alignment columns into
    weighted unique site patterns, tracking per-pattern weights,
    invariant-site flags and ambiguity flags.
  - Get_Base_Freqs / Get_AA_Freqs (utilities.c:594/710): empirical
    equilibrium frequencies with 8 EM iterations distributing
    ambiguity-code mass proportionally to current frequency estimates.

The reference uses a prefix-tree (pnode) for pattern dedup; here a
vectorized numpy unique over encoded columns does the same job in one
shot — patterns become the TPU sharding axis downstream.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from phyml_tpu_torch import datatypes
from phyml_tpu_torch.io.fasta import parse_fasta
from phyml_tpu_torch.io.phylip import parse_phylip


@dataclass
class Alignment:
    """Compressed alignment: unique site patterns with weights."""

    names: list[str]
    datatype: str                    # "nt" | "aa"
    partials: np.ndarray             # [n_otu, n_patterns, ns] float32 0/1
    weights: np.ndarray              # [n_patterns] float64 pattern counts
    site_to_pattern: np.ndarray      # [n_sites] int32
    invariant: np.ndarray            # [n_patterns] int32: state id if the
    # pattern is compatible with a single constant state, else -1
    # (reference: calign->invar, utilities.c:507-529)
    obs_state_freqs: np.ndarray = field(default=None)  # [ns] float64

    @property
    def n_otu(self) -> int:
        return len(self.names)

    @property
    def n_patterns(self) -> int:
        return self.partials.shape[1]

    @property
    def n_sites(self) -> int:
        return int(self.site_to_pattern.shape[0])

    @property
    def ns(self) -> int:
        return self.partials.shape[2]

    def resample_weights(self, rng: np.random.Generator) -> np.ndarray:
        """Multinomial bootstrap weights over original sites
        (reference: Bootstrap utilities.c:3884 draws sites uniformly)."""
        draws = rng.integers(0, self.n_sites, size=self.n_sites)
        pat = self.site_to_pattern[draws]
        return np.bincount(pat, minlength=self.n_patterns).astype(np.float64)


def compact(
    enc: np.ndarray,
    names: list[str],
    datatype: str,
    site_weights: np.ndarray | None = None,
) -> Alignment:
    """Compress encoded sites [n_otu, n_sites, ns] into unique patterns."""
    n_otu, n_sites, ns = enc.shape
    # Pack each column's tip vectors into a hashable key: the encoding
    # is 0/1 so a bit-pack over (otu, state) identifies the pattern.
    bits = (enc > 0).transpose(1, 0, 2).reshape(n_sites, n_otu * ns)
    packed = np.packbits(bits, axis=1)
    _, first_idx, inverse = np.unique(
        packed, axis=0, return_index=True, return_inverse=True
    )
    # Keep patterns in order of first appearance (reference keeps
    # first-seen order; only affects output dumps, not lnL).
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    site_to_pattern = rank[inverse].astype(np.int32)
    pattern_sites = first_idx[order]

    partials = enc[:, pattern_sites, :].astype(np.float32)
    if site_weights is None:
        site_weights = np.ones(n_sites, dtype=np.float64)
    weights = np.zeros(len(pattern_sites), dtype=np.float64)
    np.add.at(weights, site_to_pattern, site_weights)

    # Invariant flag (utilities.c:490-514): a pattern is invariant iff
    # some taxon has a definite (unambiguous) state and every taxon is
    # compatible with it; the invariant state is that definite state.
    # All-ambiguous columns (e.g. all gaps) are NOT invariant, matching
    # Assign_State returning -1 for ambiguity codes.
    compat_mask = partials > 0                       # [n_otu, n_pat, ns]
    definite = compat_mask.sum(axis=2) == 1          # [n_otu, n_pat]
    inter = compat_mask.all(axis=0)                  # [n_pat, ns]
    def_state = compat_mask.argmax(axis=2)           # [n_otu, n_pat]
    has_def = definite.any(axis=0)                   # [n_pat]
    first_def = np.where(definite, def_state, n_otu * ns)  # big sentinel
    first_tax = definite.argmax(axis=0)
    state = def_state[first_tax, np.arange(def_state.shape[1])]
    ok = has_def & inter[np.arange(inter.shape[0]), np.clip(state, 0, ns - 1)]
    invariant = np.where(ok, state, -1).astype(np.int32)
    del first_def
    aln = Alignment(
        names=list(names),
        datatype=datatype,
        partials=partials,
        weights=weights,
        site_to_pattern=site_to_pattern,
        invariant=invariant,
    )
    aln.invar_mask = (partials > 0).all(axis=0)  # [n_patterns, ns]
    aln.obs_state_freqs = empirical_freqs(aln)
    aln.input_site_weights = site_weights       # kept for re-compaction
    return aln


def remove_ambiguous_patterns(aln: Alignment) -> Alignment:
    """Drop site patterns containing any gap or ambiguity character
    (--no_gap, cl.c case 38 -> io->rm_ambigu; the reference strips
    such columns before compression).  A cell is unambiguous iff its
    tip partial is a single unit basis vector."""
    p = aln.partials
    ok_cell = (p.sum(axis=-1) == 1.0) & (p.max(axis=-1) == 1.0)
    keep = ok_cell.all(axis=0)                       # [n_patterns]
    idx = np.nonzero(keep)[0]
    remap = -np.ones(aln.n_patterns, dtype=np.int32)
    remap[idx] = np.arange(len(idx), dtype=np.int32)
    s2p = remap[aln.site_to_pattern]
    out = Alignment(
        names=list(aln.names),
        datatype=aln.datatype,
        partials=p[:, keep],
        weights=aln.weights[keep],
        site_to_pattern=s2p[s2p >= 0].astype(np.int32),
        invariant=aln.invariant[keep],
    )
    out.invar_mask = (out.partials > 0).all(axis=0)
    out.obs_state_freqs = empirical_freqs(out)
    # per-SITE weights must follow the kept sites, or a later
    # re-compaction (duplicate-taxon removal) sees a length mismatch
    isw = getattr(aln, "input_site_weights", None)
    out.input_site_weights = (None if isw is None
                              else np.asarray(isw)[s2p >= 0])
    return out


def find_duplicate_taxa(aln: Alignment) -> list[tuple[int, int]]:
    """(duplicate_index, kept_index) pairs: taxa whose encoded
    sequences are identical (reference Are_Sequences_Identical,
    called from Remove_Duplicates utilities.c:2675).  The first
    occurrence is kept."""
    codes = (aln.partials > 0).reshape(aln.n_otu, -1)
    _, first, inv = np.unique(codes, axis=0, return_index=True,
                              return_inverse=True)
    pairs = []
    for i in range(aln.n_otu):
        rep = int(first[inv[i]])
        if rep != i:
            pairs.append((i, rep))
    return pairs


def drop_taxa(aln: Alignment, drop: list[int]) -> Alignment:
    """Rebuild the alignment without the given taxa (patterns that
    merge once a distinguishing taxon is gone get re-compacted,
    matching the reference's Compact_Data re-run after
    Remove_Duplicates)."""
    dropset = set(int(d) for d in drop)
    keep = [i for i in range(aln.n_otu) if i not in dropset]
    enc = aln.partials[keep][:, aln.site_to_pattern, :]
    return compact(enc, [aln.names[i] for i in keep], aln.datatype,
                   site_weights=getattr(aln, "input_site_weights",
                                        None))


def empirical_freqs(aln: Alignment, n_iter: int = 8) -> np.ndarray:
    """EM estimate of equilibrium frequencies, distributing ambiguity
    mass by current estimates (utilities.c:594 Get_Base_Freqs /
    utilities.c:710 Get_AA_Freqs; both run 8 fixed-point iterations).

    A cell (taxon, pattern) enters the iteration only through its row
    of compatible states, so the cells are grouped by that row (a few
    dozen distinct rows: one per state plus the ambiguity codes) and
    each row carries its cells' summed pattern weight; the iteration's
    cost then no longer grows with the alignment's size."""
    ns = aln.ns
    compat = aln.partials > 0                        # [n_otu, n_pat, ns]
    nb = -(-ns // 8)
    keys = np.ascontiguousarray(np.packbits(compat, axis=-1)
                                .reshape(-1, nb)).view(f"V{nb}").ravel()
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    cell_w = np.broadcast_to(aln.weights[None, :], compat.shape[:2])
    row_w = np.bincount(inv.ravel(), weights=cell_w.ravel(),
                        minlength=len(first))[:, None]      # [R, 1]
    rows = compat.reshape(-1, ns)[first].astype(np.float64)  # [R, ns]
    f = np.full(ns, 1.0 / ns)
    for _ in range(n_iter):
        mass = rows * f
        denom = mass.sum(axis=-1, keepdims=True)
        counts = (row_w * mass / np.maximum(denom, 1e-300)).sum(axis=0)
        f = counts / counts.sum()
    return f


def read_alignment(
    path: str,
    datatype: str | None = None,
    interleaved: bool = True,
    site_weights: np.ndarray | None = None,
    codpos: int | None = None,
) -> Alignment:
    """Read PHYLIP / FASTA / NEXUS with format autodetection
    (reference autodetect: io.c:973).

    codpos (1|2|3): keep only that codon position's sites before
    pattern compression (--codpos, cl.c:412-428 +
    Restrict_To_Coding_Position utilities.c:175-192).
    datatype "generic": custom "natural numbers" alphabet with the
    state count inferred from the data (-d generic, cl.c:929)."""
    with open(path) as fh:
        text = fh.read()
    stripped = text.lstrip()
    if stripped.startswith(">"):
        names, seqs = parse_fasta(text)
    elif "#NEXUS" in text[:1024].upper():
        from phyml_tpu_torch.io.nexus import parse_nexus_alignment
        names, seqs, dt = parse_nexus_alignment(text)
        datatype = datatype or dt
    else:
        names, seqs = parse_phylip(
            text, interleaved=interleaved,
            keep_digits=(datatype == datatypes.GENERIC))
    if datatype is None:
        datatype = guess_datatype(seqs)
    if datatype == datatypes.GENERIC:
        enc, _ns = datatypes.encode_generic(seqs)
    else:
        enc = datatypes.encode_sequences([s.upper() for s in seqs],
                                         datatype)
    if codpos is not None:
        if codpos not in (1, 2, 3):
            raise ValueError("codpos must be 1, 2 or 3")
        enc = enc[:, codpos - 1::3]
        if site_weights is not None:
            site_weights = np.asarray(site_weights)[codpos - 1::3]
    return compact(enc, names, datatype, site_weights=site_weights)


def read_alignments_multi(
    path: str,
    n_sets: int,
    datatype: str | None = None,
    interleaved: bool = True,
    site_weights: np.ndarray | None = None,
) -> list[Alignment]:
    """Read `n_sets` consecutive PHYLIP data sets from one file
    (reference -n/--multiple, main.c:108 per-data-set loop)."""
    from phyml_tpu_torch.io.phylip import parse_phylip_multi

    with open(path) as fh:
        text = fh.read()
    sets = parse_phylip_multi(text, n_sets, interleaved=interleaved)
    out = []
    for names, seqs in sets:
        dt = datatype or guess_datatype(seqs)
        enc = datatypes.encode_sequences([s.upper() for s in seqs], dt)
        out.append(compact(enc, names, dt, site_weights=site_weights))
    return out


def guess_datatype(seqs: list[str]) -> str:
    """Reference heuristic: mostly-ACGTUN characters -> nucleotides."""
    sample = "".join(seqs)[:10000].upper()
    informative = [c for c in sample if c not in "-?.XN* "]
    if not informative:
        return datatypes.NT
    nt_frac = sum(c in "ACGTU" for c in informative) / len(informative)
    return datatypes.NT if nt_frac > 0.85 else datatypes.AA


def read_site_weights(path: str) -> np.ndarray:
    """Per-site weights file (reference: Read_Io_Weights io.c:1738)."""
    with open(path) as fh:
        vals = [float(tok) for tok in fh.read().split()]
    return np.asarray(vals, dtype=np.float64)
