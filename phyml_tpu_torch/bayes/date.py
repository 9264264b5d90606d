"""PhyTime: Bayesian node dating (≙ date.c DATE_Main/DATE_XML/
DATE_MCMC date.c:23/37/779).

Port of phyml_tpu/bayes/date.py.  Pipeline: alignment + rooted
starting tree (user tree, or BioNJ rooted at its longest edge) + clade
calibrations → joint MCMC over node times, lineage rates, clock rate,
tree-prior hyperparameters and substitution parameters → chronogram,
a tab-separated trace file, and a text summary (≙ the phytime
outputs: *_phyml_stats / chronogram / trace), in phyml_tpu's formats.

The XML front end accepts the reference's phytime analysis shape
(<clade id=...><taxon value=.../></clade> +
<calibration clade.id=...><lower>/<upper></calibration>,
xml.c:2417 XML_Read_Calibration) via `calibrations_from_xml`.
"""

from __future__ import annotations

import sys
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np
import torch

from phyml_tpu_torch.bayes.chrono import TimeTree
from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
from phyml_tpu_torch.bayes.rates import RateModel
from phyml_tpu_torch.bayes.times import Calibration, TimePrior


@dataclass
class DateResult:
    tree: TimeTree              # the final state's heights
    state: object               # final ChainState
    trace: np.ndarray           # [T, 5]
    acc_rate: np.ndarray
    clock_rate: float
    summary: dict
    mcmc: MCMC = None           # the chain (its ESS and move counters)


def calibrations_from_xml(path: str) -> list[Calibration]:
    """Parse <clade>/<calibration> elements from a phytime-style XML
    file (≙ XML_Read_Calibration xml.c:2417)."""
    root = ET.parse(path).getroot()
    clades: dict[str, tuple] = {}
    for cl in root.iter("clade"):
        cid = cl.attrib.get("id")
        taxa = tuple(t.attrib["value"] for t in cl.iter("taxon"))
        if cid:
            clades[cid] = taxa
    cals = []
    for cal in root.iter("calibration"):
        cid = cal.attrib.get("clade.id") or cal.attrib.get("cladeid")
        lower = upper = None
        for ch in cal:
            if ch.tag == "lower":
                lower = float(ch.text or ch.attrib.get("value", 0))
            elif ch.tag == "upper":
                upper = float(ch.text or ch.attrib.get("value", "inf"))
        taxa = clades.get(cid)
        if taxa is None:
            continue
        cals.append(Calibration(
            taxa=taxa,
            lower=lower if lower is not None else 0.0,
            upper=upper if upper is not None else float("inf"),
        ))
    return cals


def run_phytime(
    aln,
    time_tree: TimeTree,
    model=None,
    rate_kind: str = "lognormal",
    prior_kind: str = "birthdeath",
    calibrations: list[Calibration] | None = None,
    settings: MCMCSettings | None = None,
    trace_path: str | None = None,
    verbose: bool = False,
    fastlk: bool = False,
    sample_topology: bool = False,
    engine=None,
    device=None,
) -> DateResult:
    """Full dating analysis on `device` (the CUDA device unless given;
    float32 on the card, float64 on the CPU), or on `engine` when one
    is given for the alignment and model.

    sample_topology=True adds the time-tree topology moves (narrow
    exchange + prune-regraft-on-times, ≙ the reference's
    MCMC_Prune_Regraft family) so the rooted topology is sampled
    jointly with times and rates.  fastlk=True swaps the exact
    likelihood for the quadratic normal approximation around the
    starting branch lengths (the reference's --fastlk,
    Lk_Normal_Approx lk.c:2521; optim/fastlk.py)."""
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

    prior = TimePrior(kind=prior_kind,
                      calibrations=tuple(calibrations or ()))
    mcmc = MCMC(engine, model, params, time_tree,
                RateModel(kind=rate_kind), prior,
                settings=settings or MCMCSettings(), fastlk=fastlk,
                sample_topology=sample_topology)

    fh = open(trace_path, "w") if trace_path else None
    try:
        state, trace, acc = mcmc.run(trace_fh=fh, verbose=verbose)
    finally:
        if fh:
            fh.close()

    heights = state.heights.numpy()
    dated = TimeTree(n_otu=time_tree.n_otu,
                     child=state.child.numpy().copy(),
                     heights=heights.copy(), names=list(time_tree.names))
    clock = float(torch.exp(state.log_clock))
    post = trace[:, 0]
    summary = {
        "n_iter": trace.shape[0],
        "posterior_final": float(post[-1]),
        "lnL_final": float(trace[-1, 1]),
        "root_height": float(heights[dated.root]),
        "clock_rate": clock,
        "nu": float(torch.exp(state.log_nu)),
        "acceptance": {nm: float(a) for nm, a
                       in zip(MCMC.MOVE_NAMES, acc)},
    }
    return DateResult(tree=dated, state=state, trace=trace,
                      acc_rate=acc, clock_rate=clock, summary=summary,
                      mcmc=mcmc)


def print_summary(res: DateResult, out=sys.stdout) -> None:
    s = res.summary
    out.write(". Bayesian dating (phytime-equivalent) summary\n")
    out.write(f"  iterations:       {s['n_iter']}\n")
    out.write(f"  final posterior:  {s['posterior_final']:.4f}\n")
    out.write(f"  final lnL:        {s['lnL_final']:.4f}\n")
    out.write(f"  root height:      {s['root_height']:.6f}\n")
    out.write(f"  clock rate:       {s['clock_rate']:.6g}\n")
    out.write(f"  rate variation:   {s['nu']:.6g}\n")
    out.write("  chronogram: " + res.tree.to_newick() + "\n")
