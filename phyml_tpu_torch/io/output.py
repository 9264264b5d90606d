"""Result reporting: *_phyml_stats.txt / *_phyml_tree.txt writers.

Mirrors the reference's Print_Fp_Out (io.c:2524): model description,
log-likelihood, parameter estimates, frequencies, rate matrix, run
info — same information, same file naming convention, so downstream
tooling pointed at PhyML output keeps working.
"""

from __future__ import annotations

import time

import numpy as np

from phyml_tpu_torch import __version__
from phyml_tpu_torch.datatypes import AA_STATES, NT_STATES

_AA3 = {
    "A": "Ala", "R": "Arg", "N": "Asn", "D": "Asp", "C": "Cys",
    "Q": "Gln", "E": "Glu", "G": "Gly", "H": "His", "I": "Ile",
    "L": "Leu", "K": "Lys", "M": "Met", "F": "Phe", "P": "Pro",
    "S": "Ser", "T": "Thr", "W": "Trp", "Y": "Tyr", "V": "Val",
}


def format_stats(
    *,
    input_name: str,
    aln,
    model,
    params,
    lnl: float,
    topo,
    search_desc: str,
    start_tree_desc: str = "BioNJ",
    runtime_s: float | None = None,
    seed: int | None = None,
    n_parsimony: int | None = None,
    extra_lines: list[str] | None = None,
) -> str:
    pi1 = model.class_system(params)[3].numpy()[0]
    rates, probs = _class_rates(model, params)

    L = []
    L.append(" " + "o" * 96)
    L.append(f"{'---  phyml-tpu-torch ' + __version__ + '  ---':^96}")
    L.append(" a PyTorch/CUDA phylogenetic maximum-likelihood engine "
             "(PhyML-compatible)")
    L.append(" " + "o" * 96)
    L.append("")
    L.append(f". Sequence filename: \t\t\t{input_name}")
    L.append(f". Model of {'nucleotides' if model.datatype == 'nt' else 'amino acids'} substitution: \t{model.name}")
    L.append(f". Initial tree: \t\t\t{start_tree_desc}")
    L.append(f". Tree topology search: \t\t{search_desc}")
    L.append(f". Number of taxa: \t\t\t{aln.n_otu}")
    L.append(f". Log-likelihood: \t\t\t{lnl:.5f}")
    for ln in (extra_lines or []):
        L.append(ln)
    if n_parsimony is not None:
        L.append(f". Parsimony: \t\t\t\t{n_parsimony}")
    L.append(f". Tree size: \t\t\t\t{float(np.sum(topo.blen)):.5f}")
    if model.n_classes > 1 and not model.freerate:
        L.append(f". Discrete gamma model: \t\tYes")
        L.append(f"  - Number of classes: \t\t\t{model.n_classes}")
        L.append(f"  - Gamma shape parameter: \t\t"
                 f"{float(np.asarray(params['alpha'])):.3f}")
        for k in range(model.n_classes):
            L.append(f"  - Relative rate in class {k + 1}: \t\t"
                     f"{rates[k]:.5f} [freq={probs[k]:.6f}] ")
    if model.freerate:
        L.append(f". FreeRate mixture: \t\t\tYes "
                 f"({model.n_classes} classes)")
        for k in range(model.n_classes):
            L.append(f"  - Rate class {k + 1}: \t\t\trate={rates[k]:.5f} "
                     f"weight={probs[k]:.6f}")
    if model.invar:
        L.append(f". Proportion of invariant: \t\t"
                 f"{float(np.asarray(params.get('pinv', 0.0))):.3f}")
    if model.datatype == "nt":
        if "kappa" in params:
            kappa = float(np.asarray(params["kappa"]))
            L.append(f". Transition/transversion ratio: \t{kappa:.6f}")
        L.append(". Nucleotides frequencies:")
        for i, c in enumerate(NT_STATES):
            L.append(f"  - f({c})=  {pi1[i]:.5f}")
        if "rr_val" in params:
            rr = np.exp(np.asarray(params["rr_val"]))
            rr = rr / rr[-1]
            pairs = ["A <-> C", "A <-> G", "A <-> T",
                     "C <-> G", "C <-> T", "G <-> T"]
            L.append(". GTR relative rate parameters : ")
            for pr, r in zip(pairs, rr):
                L.append(f"  {pr}    {r:.5f}")
    elif model.datatype == "generic":
        L.append(". State frequencies (custom alphabet):")
        for i in range(len(pi1)):
            L.append(f"  - f({i})=  {pi1[i]:.5f}")
    else:
        L.append(". Amino-acid frequencies")
        row = []
        for i, c in enumerate(AA_STATES):
            row.append(f"f({_AA3[c]})= {pi1[i]:.6f}")
            if len(row) == 3:
                L.append("- " + " ".join(row))
                row = []
        if row:
            L.append("- " + " ".join(row))
    if seed is not None:
        L.append(f". Random seed: \t\t\t\t{seed}")
    if runtime_s is not None:
        h, rem = divmod(int(runtime_s), 3600)
        m, s = divmod(rem, 60)
        L.append(f". Time used: \t\t\t\t{h}h{m}m{s}s "
                 f"({int(runtime_s)} seconds)")
    L.append("")
    L.append(" " + "o" * 96)
    return "\n".join(L) + "\n"


def _class_rates(model, params):
    from phyml_tpu_torch.models.rates import (
        discrete_gamma, freerate_normalize,
    )

    if model.freerate:
        r, w = freerate_normalize(params["class_rates_raw"],
                                  params["class_weights_raw"])
        return np.asarray(r), np.asarray(w)
    if model.n_classes > 1:
        r, w = discrete_gamma(params["alpha"], model.n_classes,
                              median=model.gamma_median)
        return np.asarray(r), np.asarray(w)
    return np.ones(1), np.ones(1)


def write_results(
    prefix: str,
    topo,
    names,
    stats_text: str,
    support: dict[int, float] | None = None,
    support_fmt: str = "%.2f",
    append: bool = False,
) -> tuple[str, str]:
    """Write <prefix>_phyml_tree.txt and <prefix>_phyml_stats.txt
    (reference naming: io.c output file conventions).  Returns the two
    paths.  append=True adds to existing files (the reference's
    -n/--multiple data sets share one tree and one stats file)."""
    tree_path = f"{prefix}_phyml_tree.txt"
    stats_path = f"{prefix}_phyml_stats.txt"
    sup = None
    if support is not None:
        sup = {eid: support_fmt % val for eid, val in support.items()}
    mode = "a" if append else "w"
    with open(tree_path, mode) as fh:
        fh.write(topo.to_newick(names, support=sup) + "\n")
    with open(stats_path, mode) as fh:
        fh.write(stats_text)
    return tree_path, stats_path


def write_site_lnl(path: str, aln, site_logliks) -> None:
    """Per-site log-likelihood dump (reference: Print_Site_Lk
    io.c:1870, --print_site_lnl)."""
    s = site_logliks.double().cpu().numpy()[aln.site_to_pattern]
    with open(path, "w") as fh:
        fh.write("Site\tlogLK\n")
        for i, v in enumerate(s):
            fh.write(f"{i + 1}\t{v:.6f}\n")


class TraceWriter:
    """Search-progress traces (≙ the reference's --print_trace newick
    stream, io.c fp_out_trace, and --json_trace JSON snapshots,
    JSON_Tree_Io io.c:6737, hooked at every improvement: main.c:256,
    spr.c:781, optimiz.c:989).

    newick_path: one newick line per improvement.
    json_path:   a JSON array of {"state": {"state_num", "time",
                 "tree", "lnL"}} objects, valid JSON after every
                 snapshot (the reference patches the closing ']' in
                 place; here the array is rewritten — snapshots are
                 rare relative to their cost)."""

    def __init__(self, names, newick_path=None, json_path=None):
        self.names = list(names)
        self.newick_path = newick_path
        self.json_path = json_path
        self._states = []
        self._t0 = time.time()
        if newick_path:
            open(newick_path, "w").close()

    @property
    def active(self) -> bool:
        return bool(self.newick_path or self.json_path)

    def snapshot(self, topo, lnl: float) -> None:
        nwk = topo.to_newick(self.names)
        if self.newick_path:
            with open(self.newick_path, "a") as fh:
                fh.write(nwk + "\n")
        if self.json_path:
            import json
            self._states.append({"state": {
                "state_num": len(self._states),
                "time": int(time.time() - self._t0),
                "tree": nwk,
                "lnL": round(float(lnl), 5),
            }})
            with open(self.json_path, "w") as fh:
                json.dump(self._states, fh, indent=1)
