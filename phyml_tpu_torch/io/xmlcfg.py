"""XML analysis front end (the reference's xml.c / --xml flag).

Port of the ML part of phyml_tpu/io/xmlcfg.py.  Supports the phyml
XML schema's core: <phyml> root attributes (run.id, output.file,
branch.test), <topology>, <ratematrices> (built-in models or customaa
files), <siterates> (discrete gamma, gamma+inv, freerates with
weights), <equfreqs>, <branchlengths>, and a <partitionelem>
assembling mixture classes via <mixtureelem> lists (xml.c:6
XML_Process_Base; class assembly mirrors the chained-tree construction
the reference builds in mixt.c — here a mixture is just the class axis
of one engine).

Multiple <partitionelem> blocks run as a shared-topology partitioned
analysis (search/partitioned.py); a <phytime> root runs the Bayesian
dating chain (_run_xml_bayes, bayes/date.py) and a <phyrex> root the
joint phylogeography chain (bayes/phyrex.py: the <spatialmodel>'s
movement model, SLFV when it is absent, on the tip coordinates of
<coordinates>); the root's mutmap="yes" attribute writes a mutation
map of the final tree (_write_mutmap).  `parse_xml` is a copy of
phyml_tpu's parser.

    python -m phyml_tpu_torch.cli --xml run.xml --platform gpu
"""

from __future__ import annotations

import os
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

def parse_xml(path: str) -> dict:
    """Parse into a plain config dict (no side effects)."""
    tree = ET.parse(path)
    root = tree.getroot()
    base = os.path.dirname(os.path.abspath(path))
    cfg = {
        "kind": root.tag,                    # phyml | phytime | phyrex
        "run_id": root.get("run.id"),
        "output_file": root.get("output.file"),
        "branch_test": root.get("branch.test", "no"),
        "r_seed": int(float(root.get("r.seed", "0"))),
        # MCMC driver attributes (phytime/phyrex roots, xml.c)
        "mcmc": {
            "chain_len": int(float(root.get("mcmc.chain.len", "1e5"))),
            "sample_every": int(float(root.get("mcmc.sample.every",
                                               "1000"))),
            "burnin": int(float(root.get("mcmc.burnin", "1000"))),
        },
        "lineagerates": None,
        "clockrate": {},
        "coordinates": None,
        # reference default when <spatialmodel> is absent: the SLFV
        # Gaussian event-disk model (init.c:6097), NOT the RRW
        "spatialmodel": "slfv",
        "spatial_dist": "euclidean",
        # root attribute mutmap="yes": write sampled substitution
        # histories (phyrex.c mutmap path -> ancestral.c:411)
        "mutmap": root.get("mutmap", "no").lower()
        in ("yes", "true", "1"),
        "topology": {},
        "ratematrices": {},
        "siterates": {},
        "siterate_weights": {},
        "equfreqs": {},
        "branchlengths": {},
        "partitions": [],
    }

    lr = root.find("lineagerates")
    if lr is not None:
        name = lr.get("model", "lognormal").lower()
        # reference name aliases (date.c:140-190): the
        # geometric-Brownian "integrated" clock is Guindon 2012;
        # "strictclock"/"strict" map to the strict clock
        aliases = {
            "geometricbrownian": "guindon", "geometric": "guindon",
            "integrated": "guindon", "geo": "guindon",
            "strictclock": "strict", "strict": "strict",
            "clock": "strict",
            "lognormal": "lognormal", "normal": "lognormal",
            "thorne": "thorne", "autocorrelated": "thorne",
        }
        cfg["lineagerates"] = aliases.get(name, name)
    else:
        # reference default when <lineagerates> is absent: the
        # Guindon geometric-Brownian clock (date.c:129-135)
        cfg["lineagerates"] = "guindon"

    sm = root.find("spatialmodel")
    if sm is not None:
        name = (sm.get("name") or "slfv").lower()
        # reference name table (phyrex.c:320-331); the rrw variants
        # and the integrated models map onto bayes.traits kinds
        sm_aliases = {
            "slfv": "slfv", "rw": "rw",
            "rrw+gamma": "rrw", "rrw+lognormal": "rrw",
            "ibm": "ibm", "ribm": "ibm",
            "iwn": "iwn", "riwn": "iwn",
            "iwnu": "iwn", "riwnu": "iwn",
            "iou": "iou",
        }
        if name not in sm_aliases:
            raise ValueError(f"unknown spatial model {name!r}")
        cfg["spatialmodel"] = sm_aliases[name]
        dist = (sm.get("distance.type") or "euclidean").lower()
        # reference aliases (phyrex.c:340-346): HAVERSINE
        if dist in ("great circle", "greatcircle"):
            cfg["spatial_dist"] = "greatcircle"
    cr = root.find("clockrate")
    if cr is not None:
        cfg["clockrate"] = {
            "value": float(cr.get("value", "1.0")),
            "optimise": cr.get("optimise.clock",
                               cr.get("optimize.clock", "true"))
            not in ("false", "no"),
        }
    co = root.find("coordinates")
    if co is not None:
        cfg["coordinates"] = os.path.normpath(
            os.path.join(base, co.get("file.name")))

    topo = root.find("topology")
    if topo is not None:
        inst = topo.find("instance")
        cfg["topology"] = {
            "init_tree": inst.get("init.tree", "bionj"),
            "optimise": inst.get("optimise.tree", "yes") == "yes",
            "file": inst.get("file.name"),
            "search": inst.get("search", "spr").upper(),
        }

    for rm in root.findall("ratematrices"):
        for inst in rm.findall("instance"):
            entry = {"model": inst.get("model", "gtr").upper()}
            f = inst.get("ratematrix.file")
            if f:
                entry["file"] = os.path.normpath(os.path.join(base, f))
            cfg["ratematrices"][inst.get("id")] = entry

    for sr in root.findall("siterates"):
        for inst in sr.findall("instance"):
            cfg["siterates"][inst.get("id")] = {
                "init_value": float(inst.get("init.value", "1.0")),
            }
        w = sr.find("weights")
        if w is not None:
            cfg["siterate_weights"] = {
                "family": w.get("family", "gamma"),
                "alpha": float(w.get("alpha", "1.0"))
                if w.get("alpha") not in (None, "estimated") else "e",
                "optimise": w.get("optimise.freerates", "no") == "yes"
                or w.get("optimise.alpha", "no") == "yes",
                "values": {
                    i.get("appliesto"): float(i.get("value", "1.0"))
                    for i in w.findall("instance")
                },
            }

    for ef in root.findall("equfreqs"):
        for inst in ef.findall("instance"):
            cfg["equfreqs"][inst.get("id")] = {
                "freqs": inst.get("freqs",
                                  inst.get("base.freqs", "empirical")),
            }

    for bl in root.findall("branchlengths"):
        for inst in bl.findall("instance"):
            cfg["branchlengths"][inst.get("id")] = {
                "optimise": inst.get("optimise.lens", "yes") == "yes",
            }

    for pe in root.findall("partitionelem"):
        classes = {}
        for me in pe.findall("mixtureelem"):
            ids = [t.strip() for t in me.get("list", "").split(",")]
            classes[len(classes)] = ids
        # rows: topology, matrices, freqs, rates, lengths (in the
        # order the reference's examples use; identify by id prefix)
        rows = list(classes.values())
        cfg["partitions"].append({
            "file": os.path.normpath(
                os.path.join(base, pe.get("file.name"))),
            "datatype": pe.get("data.type", "nt"),
            "interleaved": pe.get("interleaved", "yes") == "yes",
            "rows": rows,
        })
    return cfg


def build_model_from_xml(cfg: dict, part: dict):
    """Build (SubstModel, init_params overrides) for one partition."""
    from phyml_tpu_torch.models import matrices as mat
    from phyml_tpu_torch.models.substitution import SubstModel

    rows = part["rows"]

    # classify rows by which table their ids appear in
    def row_kind(ids):
        i0 = ids[0]
        if i0 in cfg["ratematrices"]:
            return "matrix"
        if i0 in cfg["siterates"]:
            return "rate"
        if i0 in cfg["equfreqs"]:
            return "freq"
        if i0 in cfg["branchlengths"]:
            return "blen"
        return "topology"

    by_kind = {row_kind(r): r for r in rows}
    mat_ids = by_kind.get("matrix")
    rate_ids = by_kind.get("rate")
    freq_ids = by_kind.get("freq")
    n_classes = max(len(r) for r in rows)

    datatype = part["datatype"]
    components = None
    name = "GTR" if datatype == "nt" else "LG"
    if mat_ids:
        uniq = list(dict.fromkeys(mat_ids))
        specs = [cfg["ratematrices"][i] for i in uniq]
        if len(uniq) > 1 or "file" in specs[0]:
            components = []
            for i in mat_ids:
                spec = cfg["ratematrices"][i]
                if "file" in spec:
                    S, pi = mat.read_paml_matrix(spec["file"])
                else:
                    S, pi = mat.empirical_aa(spec["model"].lower())
                components.append((S, pi))
        else:
            name = specs[0]["model"]

    freerate = (cfg["siterate_weights"].get("family") == "freerates")
    model = SubstModel(
        datatype=datatype,
        name=name if components is None else "XMLMIX",
        n_classes=n_classes,
        freerate=freerate,
        components=components,
        freqs_mode="model" if (freq_ids and cfg["equfreqs"][
            freq_ids[0]]["freqs"] == "model") else None,
    )

    overrides = {}
    if rate_ids and (freerate or components):
        rates = np.asarray([cfg["siterates"][i]["init_value"]
                            for i in rate_ids])
        wts = np.asarray([
            cfg["siterate_weights"]["values"].get(i, 1.0 / n_classes)
            for i in rate_ids
        ])
        overrides["class_rates_raw"] = np.log(rates)
        overrides["class_weights_raw"] = np.log(wts)
    return model, overrides


def _partition_setup(cfg: dict, part: dict, device, dtype, names=None):
    """(alignment, Partition) of one <partitionelem>: its alignment
    (rows in `names` order when given), model, starting parameters and
    engine."""
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine
    from phyml_tpu_torch.search.partitioned import Partition, reorder_taxa

    aln = read_alignment(part["file"], datatype=part["datatype"],
                         interleaved=part["interleaved"])
    if names is not None:
        aln = reorder_taxa(aln, names)
    model, overrides = build_model_from_xml(cfg, part)
    params = model.init_params(aln.obs_state_freqs)
    for k, v in overrides.items():
        params[k] = torch.as_tensor(v, dtype=torch.float64)
    engine = LikelihoodEngine(aln, model, dtype=dtype, device=device)
    return aln, Partition(engine, model, params)


def _prefix(path: str, cfg: dict) -> str:
    """Output prefix: the first partition's file and run id, or
    output.file next to the xml."""
    run_id = f"_{cfg['run_id']}" if cfg["run_id"] else ""
    prefix = f"{cfg['partitions'][0]['file']}{run_id}"
    if cfg["output_file"]:
        prefix = os.path.join(os.path.dirname(os.path.abspath(path)),
                              cfg["output_file"])
    return prefix


def run_xml(path: str, quiet: bool = False, device=None,
            mcmc_iter_cap: int | None = None) -> int:
    """Run the analysis a <phyml>, <phytime> or <phyrex> root
    describes on `device` (the CUDA device unless given), float32 on
    the card and float64 on the CPU; returns the exit code.
    mcmc_iter_cap bounds a chain's length below the XML's
    mcmc.chain.len (tests and smoke runs; an analysis runs the XML's
    value, as the reference does)."""
    from phyml_tpu_torch.io.output import format_stats, write_results
    from phyml_tpu_torch.ops.likelihood import default_device, tree_arrays
    from phyml_tpu_torch.optim.round import round_optimize
    from phyml_tpu_torch.search.bionj import bionj_start
    from phyml_tpu_torch.search.driver import nni_search, spr_search
    from phyml_tpu_torch.search.nni import _host_blen
    from phyml_tpu_torch.topology import Topology

    t0 = time.time()
    cfg = parse_xml(path)
    if not cfg["partitions"]:
        raise ValueError(f"{path}: no <partitionelem> found")
    device = default_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    if cfg["kind"] in ("phytime", "phyrex"):
        return _run_xml_bayes(path, cfg, quiet, mcmc_iter_cap, device,
                              dtype)
    if len(cfg["partitions"]) > 1:
        return _run_xml_partitioned(path, cfg, t0, quiet, device, dtype)
    part = cfg["partitions"][0]
    aln, (engine, model, params) = _partition_setup(cfg, part, device,
                                                    dtype)

    tcfg = cfg["topology"]
    if tcfg.get("file"):
        with open(tcfg["file"]) as fh:
            topo = Topology.from_newick(fh.read(), aln.names)
        start_desc = "user tree"
    else:
        topo = bionj_start(engine, params)
        start_desc = "BioNJ"

    if tcfg.get("optimise", True):
        searcher = spr_search if tcfg.get("search") != "NNI" \
            else nni_search
        topo, params, lnl = searcher(engine, model, params, topo,
                                     verbose=not quiet)
        search_desc = tcfg.get("search", "SPR")
    else:
        rv = topo.rooted()
        params, ta, lnl = round_optimize(
            engine, model, params,
            tree_arrays(rv, dtype=dtype, device=device),
        )
        topo.set_blen_from_rooted(rv, _host_blen(ta))
        search_desc = "none"

    stats = format_stats(
        input_name=part["file"], aln=aln, model=model, params=params,
        lnl=lnl, topo=topo, search_desc=search_desc,
        start_tree_desc=start_desc, runtime_s=time.time() - t0,
    )
    tree_path, stats_path = write_results(_prefix(path, cfg), topo,
                                          aln.names, stats)
    if not quiet:
        print(f". Log-likelihood: {lnl:.5f}")
        print(f". Results written to {tree_path} and {stats_path}")
    return 0


def _run_xml_partitioned(path: str, cfg: dict, t0: float, quiet: bool,
                         device, dtype) -> int:
    """Multi-<partitionelem> analysis: shared topology, per-partition
    models/branch lengths, combined-likelihood search (≙ the
    reference's chained partition trees, mixt.c MIXT_Lk)."""
    from phyml_tpu_torch.io.output import format_stats, write_results
    from phyml_tpu_torch.ops.likelihood import tree_arrays
    from phyml_tpu_torch.search.bionj import bionj_start
    from phyml_tpu_torch.search.partitioned import partitioned_search
    from phyml_tpu_torch.topology import Topology

    alns, parts = [], []
    names = None
    for part in cfg["partitions"]:
        aln, p = _partition_setup(cfg, part, device, dtype, names)
        names = list(aln.names)
        alns.append(aln)
        parts.append(p)

    tcfg = cfg["topology"]
    if tcfg.get("file"):
        with open(tcfg["file"]) as fh:
            topo0 = Topology.from_newick(fh.read(), names)
        start_desc = "user tree"
    else:
        topo0 = bionj_start(parts[0].engine, parts[0].params)
        start_desc = "BioNJ (partition 1)"

    search = tcfg.get("search", "SPR")
    topos, parts, lnl = partitioned_search(
        parts, topo0, search=search,
        opt_params=tcfg.get("optimise", True), verbose=not quiet)

    prefix = _prefix(path, cfg)
    # one stats+tree pair per partition (matching the reference's
    # per-partition output blocks), plus the combined lnL up front
    outputs = []
    for k, (aln, (eng, model, params), topo) in enumerate(
            zip(alns, parts, topos)):
        ta = tree_arrays(topo.rooted(), dtype=eng.dtype, device=eng.device)
        lnl_k = float(eng.loglik(params, ta))
        stats = format_stats(
            input_name=cfg["partitions"][k]["file"], aln=aln,
            model=model, params=params, lnl=lnl_k, topo=topo,
            search_desc=search, start_tree_desc=start_desc,
            runtime_s=time.time() - t0,
            extra_lines=[f". Combined log-likelihood "
                         f"(all {len(parts)} partitions): {lnl:.5f}"],
        )
        suffix = f"_part{k + 1}" if len(parts) > 1 else ""
        outputs.append(write_results(f"{prefix}{suffix}", topo, names,
                                     stats))
    if not quiet:
        print(f". Combined log-likelihood: {lnl:.5f}")
        for tree_path, stats_path in outputs:
            print(f". Results written to {tree_path} and {stats_path}")
    return 0


def read_coordinates(path: str, names: list[str]) -> np.ndarray:
    """Parse a phyrex coordinates file (usa_coord.txt format:
    '# state.name lon lat' header then '|Name| lon lat' rows) and map
    each taxon to its row.  The reference matches a row when its name
    token appears in the taxon label (PHYREX_XML's coordinate lookup);
    exact taxon-name rows also match."""
    rows: dict[str, tuple[float, float]] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 3:
                continue
            try:
                xy = (float(parts[-2]), float(parts[-1]))
            except ValueError:
                continue
            rows[" ".join(parts[:-2])] = xy
    out = np.zeros((len(names), 2))
    for i, nm in enumerate(names):
        hit = rows.get(nm)
        if hit is None:
            for key, xy in rows.items():
                if key and key in nm:
                    hit = xy
                    break
        if hit is None:
            raise ValueError(f"no coordinates for taxon {nm!r} "
                             f"in {path}")
        out[i] = hit
    return out


def _run_xml_bayes(path: str, cfg: dict, quiet: bool,
                   mcmc_iter_cap: int | None, device, dtype) -> int:
    """<phytime> / <phyrex> execution: build the model from the same
    schema elements as <phyml>, construct a starting chronogram (the
    user tree or BioNJ, its branch lengths fitted, rooted on its last
    edge), read the calibrations (the coordinates for phyrex), run the
    joint MCMC, write trace + stats + chronogram (≙ DATE_XML date.c:37
    and PHYREX_XML phyrex.c:37)."""
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.bayes.date import calibrations_from_xml
    from phyml_tpu_torch.bayes.mcmc import MCMCSettings
    from phyml_tpu_torch.ops.likelihood import tree_arrays
    from phyml_tpu_torch.optim.blen import optimize_branch_lengths
    from phyml_tpu_torch.search.bionj import bionj_start
    from phyml_tpu_torch.search.nni import _host_blen
    from phyml_tpu_torch.topology import Topology

    aln, (engine, model, params) = _partition_setup(
        cfg, cfg["partitions"][0], device, dtype)
    tcfg = cfg["topology"]
    if tcfg.get("file"):
        with open(tcfg["file"]) as fh:
            topo = Topology.from_newick(fh.read(), aln.names)
    else:
        topo = bionj_start(engine, params)
    rv = topo.rooted()
    ta, _ = optimize_branch_lengths(
        engine, params, tree_arrays(rv, dtype=dtype, device=device))
    topo.set_blen_from_rooted(rv, _host_blen(ta))
    tt = TimeTree.from_topology(topo, names=list(aln.names))

    n_iter = cfg["mcmc"]["chain_len"]
    if mcmc_iter_cap is not None:
        n_iter = min(n_iter, mcmc_iter_cap)
    settings = MCMCSettings(
        n_iter=n_iter,
        burnin=min(cfg["mcmc"]["burnin"], n_iter // 2),
        thin=max(1, cfg["mcmc"]["sample_every"]),
        seed=cfg["r_seed"],
    )
    rate_kind = cfg["lineagerates"] or "lognormal"
    sample_topo = tcfg.get("optimise", True)
    base = os.path.dirname(os.path.abspath(path))
    prefix = os.path.join(base, cfg["output_file"] or "phyml_tpu_out")
    if cfg["run_id"]:
        prefix += f"_{cfg['run_id']}"
    trace_path = prefix + "_phyml_trace.txt"
    if cfg["kind"] == "phyrex":
        # the substitution parameters are the model's initial ones, as
        # in phyml_tpu's run_phyrex (the XML's overrides fit only the
        # start chronogram); the node-time prior is the coalescent
        from phyml_tpu_torch.bayes.phyrex import print_summary, run_phyrex
        coords = read_coordinates(cfg["coordinates"], list(aln.names))
        res = run_phyrex(
            aln, coords, tt, model=model,
            trait_kind=cfg["spatialmodel"], rate_kind=rate_kind,
            settings=settings, trace_path=trace_path, verbose=not quiet,
            sample_topology=sample_topo, spatial_dist=cfg["spatial_dist"],
            engine=engine)
    else:
        from phyml_tpu_torch.bayes.date import print_summary, run_phytime
        res = run_phytime(
            aln, tt, model=model, rate_kind=rate_kind,
            prior_kind="birthdeath", calibrations=calibrations_from_xml(path),
            settings=settings, trace_path=trace_path, verbose=not quiet,
            sample_topology=sample_topo, engine=engine)

    with open(prefix + "_phyml_stats.txt", "w") as fh:
        print_summary(res, out=fh)
    with open(prefix + "_chronogram.txt", "w") as fh:
        fh.write(res.tree.to_newick() + "\n")
    if cfg.get("mutmap"):
        _write_mutmap(prefix + "_phyml_mutmap.txt", engine, params,
                      res, cfg["r_seed"])
        if not quiet:
            print(f". Mutation map written to "
                  f"{prefix}_phyml_mutmap.txt")
    if not quiet:
        print_summary(res)
        print(f". Trace written to {trace_path}")
    return 0


def _write_mutmap(path: str, engine, params, res, seed: int) -> None:
    """Sampled substitution histories on the posterior tree (the
    reference's mutmap output: phyrex.c mutmap path feeding
    Sample_Ancestral_Seq / ancestral.c:411), as phyml_tpu writes them:
    one joint draw of (rate classes, ancestral states) on the engine's
    device (a torch.Generator seeded with r.seed), then endpoint-
    conditioned path sampling per (edge, site) on the host
    (default_rng(seed + 31))."""
    from phyml_tpu_torch.ops.ancestral import (
        map_mutations, sample_ancestral, write_mutmap,
    )
    from phyml_tpu_torch.ops.likelihood import TreeArrays

    tt = res.tree
    par = np.asarray(tt.parent)
    heights = np.asarray(tt.heights)
    clock = float(res.summary.get("clock_rate", 1.0))
    dt = np.where(par != np.arange(tt.n_nodes),
                  heights[par] - heights, 0.0)
    blen = np.maximum(clock * dt, 0.0)
    tree = TreeArrays(
        child=torch.as_tensor(np.asarray(tt.child, dtype=np.int32)),
        blen=torch.as_tensor(blen, dtype=engine.dtype,
                             device=engine.device))
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(seed)
    classes, states = sample_ancestral(engine, params, tree, gen)
    events = map_mutations(engine, params, tree, classes, states,
                           np.random.default_rng(seed + 31))
    write_mutmap(path, events)
