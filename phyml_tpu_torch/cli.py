"""Command-line front end, mirroring the reference's phyml CLI.

Reference: Read_Command_Line (cl.c:19) and the per-dataset
loop (main.c:108-434).  The parser takes the same flags as
phyml_tpu's; this port runs the `phyml` ML run on DNA and on amino
acids (LG, WAG, JTT and the other empirical matrices): the start tree
(`-u` tree, `--rand_start`, `--pars_start`, a resolution of
`--constraint_file`, else ML distances and BioNJ), the topology search
(`-o` with `t`, `-s NNI|SPR|BEST`, `--n_rand_starts`,
`--min_diff_lk_global`, `--no_five_branch`, `--constraint_file`,
`--print_trace`, `--json_trace`) or the fixed-topology fit (`-o` in
{l, r, lr, n/''}), branch supports (`-b N` bootstrap with `--tbe`,
`--bayesian_bootstrap`, `--rapid_boot`; `-b -1/-2/-3/-4/-5` aLRT,
SH-aLRT and aBayes), the model and data flags, and `--print_site_lnl`.
Every other analysis flag stops the run with a message naming the
ROADMAP.md item that ports it.

    python -m phyml_tpu_torch.cli -i aln.phy -m GTR -c 4 -b 0 \\
        --platform gpu                       # BioNJ, then NNI search
    python -m phyml_tpu_torch.cli -i aln.phy -m GTR -c 4 -b -5 \\
        --platform gpu                       # ... then aBayes supports
    python -m phyml_tpu_torch.cli -i prot.phy -u tree.nwk -d aa -m LG \\
        -c 4 -a e -o lr -b 0 --platform gpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phyml-tpu-torch",
        description="PyTorch/CUDA phylogenetic ML (PhyML-compatible CLI)",
    )
    p.add_argument("-i", "--input", required=True,
                   help="PHYLIP/FASTA/NEXUS alignment")
    p.add_argument("-d", "--datatype",
                   choices=["nt", "aa", "generic", "gen"],
                   default=None)
    p.add_argument("-q", "--sequential", action="store_true",
                   help="sequential (non-interleaved) PHYLIP")
    p.add_argument("-n", "--multiple", type=int, default=1,
                   help="number of data sets (PHYLIP multi-alignment)")
    p.add_argument("-m", "--model", default=None,
                   help="JC69|K80|F81|HKY85|F84|TN93|GTR|custom string "
                        "| LG|WAG|JTT|...|LG4X (aa)")
    p.add_argument("-f", "--frequencies", default=None,
                   help="'e' empirical, 'm' model/ML, 'o' optimized, "
                        "or 'fA,fC,fG,fT'")
    p.add_argument("-t", "--ts_tv", default="e",
                   help="transition/transversion ratio (or 'e')")
    p.add_argument("-c", "--n_classes", "--nclasses", type=int,
                   default=4)
    # reference default: alpha FIXED at 1.0 unless `-a e`
    p.add_argument("-a", "--alpha", default="1.0",
                   help="gamma shape (or 'e' to estimate)")
    p.add_argument("-v", "--pinv", default="0.0",
                   help="proportion of invariant sites (or 'e')")
    p.add_argument("--free_rates", "--freerates", "--freerate",
                   action="store_true",
                   help="FreeRate model instead of discrete gamma")
    p.add_argument("--codpos", type=int, default=None,
                   help="analyse only this codon position (1|2|3)")
    p.add_argument("--aa_rate_file", default=None,
                   help="PAML-format custom AA rate matrix")
    p.add_argument("--il", action="store_true",
                   help="integrated-length model")
    p.add_argument("-u", "--user_tree", "--inputtree",
                   default=None,
                   help="starting tree newick file")
    p.add_argument("-o", "--optimize", default="tlr",
                   help="t=topology l=lengths r=rates; 'n' = none")
    p.add_argument("-s", "--search", choices=["NNI", "SPR", "BEST"],
                   default="NNI")
    p.add_argument("-b", "--bootstrap", type=int, default=0,
                   help=">0: replicates; 0: none; -1: aLRT stat; "
                        "-2: aLRT chi2; -4: SH-aLRT; -5: aBayes")
    p.add_argument("--tbe", action="store_true")
    p.add_argument("--bayesian_bootstrap", action="store_true")
    p.add_argument("--rapid_boot", action="store_true")
    p.add_argument("--r_seed", type=int, default=None)
    p.add_argument("--rand_start", action="store_true")
    p.add_argument("--n_rand_starts", type=int, default=5)
    p.add_argument("--pars_start", action="store_true")
    p.add_argument("--constraint_file", default=None)
    p.add_argument("--platform", choices=["cpu", "gpu"], default="gpu",
                   help="device to run on (default gpu: one CUDA "
                        "device; cpu runs float64 unless --float32)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--weights", default=None,
                   help="site-weight file")
    p.add_argument("--cov", action="store_true")
    p.add_argument("--cov_delta", default=None)
    p.add_argument("--cov_alpha", default=None)
    p.add_argument("--cov_ncats", type=int, default=3)
    p.add_argument("--cov_free", action="store_true")
    p.add_argument("--cv", choices=["tip", "kfold.col", "kfold.pos"],
                   default=None)
    p.add_argument("--ancestral", "--anc", action="store_true")
    p.add_argument("--ps", action="store_true")
    p.add_argument("--print_site_lnl", "--print_site_lk",
                   action="store_true")
    p.add_argument("--print_trace", action="store_true")
    p.add_argument("--json_trace", action="store_true")
    p.add_argument("--min_diff_lk_global", type=float, default=None)
    p.add_argument("--no_five_branch", action="store_true")
    p.add_argument("--alias_subpatt", action="store_true")
    p.add_argument("--mutmap", action="store_true")
    p.add_argument("--no_gap", action="store_true")
    p.add_argument("--append", action="store_true",
                   help="append to existing output files instead of "
                        "overwriting (cl.c case 40)")
    p.add_argument("--leave_duplicates", action="store_true")
    p.add_argument("--no_memory_check", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--run_id", default=None)
    p.add_argument("--xml", default=None)
    p.add_argument("--datatype_guess", action="store_true")
    p.add_argument("--float32", action="store_true",
                   help="fp32 likelihood (default on the GPU; fp64 on "
                        "the CPU)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint_every", type=int, default=300)
    return p


# ROADMAP.md Queue 1 items that port what this CLI does not run yet
_CLI = "Queue 1, 'Remaining CLI flags and the checkpoint'"
_MODELS = "Queue 1, 'Covarion, mixtures and partitions'"
_SUPPORT = "Queue 1, 'Supports, bootstrap and multi-GPU'"
_TOOLS = "Queue 1, 'Auxiliary tools'"


def _unported(args) -> list[tuple[str, str]]:
    """(flag, ROADMAP item) for every requested feature this port does
    not run yet."""
    checks = [
        (args.distributed, "--distributed", _SUPPORT),
        (args.cov or args.cov_free or args.cov_delta is not None
         or args.cov_alpha is not None, "--cov*", _MODELS),
        ((args.model or "").upper() == "LG4X", "-m LG4X", _MODELS),
        (args.xml is not None, "--xml", _MODELS),
        (args.il, "--il", _CLI),
        (args.aa_rate_file is not None, "--aa_rate_file", _CLI),
        (args.multiple != 1, "-n other than 1", _CLI),
        (args.codpos is not None, "--codpos", _CLI),
        (args.weights is not None, "--weights", _CLI),
        (args.no_gap, "--no_gap", _CLI),
        (args.checkpoint is not None, "--checkpoint", _CLI),
        (args.datatype_guess, "--datatype_guess", _CLI),
        (args.cv is not None, "--cv", _TOOLS),
        (args.ancestral, "--ancestral", _TOOLS),
        (args.ps, "--ps", _TOOLS),
        (args.mutmap, "--mutmap", _TOOLS),
        (args.alias_subpatt, "--alias_subpatt", _TOOLS),
    ]
    return [(flag, item) for hit, flag, item in checks if hit]


def _build_model(args, aln):
    from phyml_tpu_torch.models.substitution import SubstModel

    if aln.datatype == "generic":
        # custom alphabet: JC over the inferred state count
        # (cl.c:929-932, init.c:1519-1533)
        return SubstModel(
            datatype="generic",
            generic_ns=int(aln.partials.shape[-1]),
            n_classes=args.n_classes,
            invar=(args.pinv == "e" or float(args.pinv or 0) > 0),
            optimize_alpha="r" in args.optimize and args.alpha == "e",
            optimize_pinv="r" in args.optimize and args.pinv == "e",
        )
    name = args.model
    if name is None:
        name = "HKY85" if aln.datatype == "nt" else "LG"
    freqs_mode = None
    fixed = None
    if args.frequencies:
        f = args.frequencies
        if f == "e":
            freqs_mode = "empirical"
        elif f == "m":
            freqs_mode = "model" if aln.datatype == "aa" else "optimize"
        elif f == "o":
            freqs_mode = "optimize"
        else:
            fixed = np.asarray([float(x) for x in f.split(",")])
            freqs_mode = "fixed"
    opt_r = "r" in args.optimize
    return SubstModel(
        datatype=aln.datatype,
        name=name,
        n_classes=args.n_classes,
        invar=(args.pinv == "e" or float(args.pinv or 0) > 0),
        freerate=args.free_rates,
        freqs_mode=freqs_mode,
        fixed_freqs=fixed,
        optimize_kappa=opt_r and args.ts_tv == "e",
        optimize_alpha=opt_r and args.alpha == "e",
        optimize_pinv=opt_r and args.pinv == "e",
        optimize_rr=opt_r,
    )


def _init_params(args, model, aln):
    params = model.init_params(aln.obs_state_freqs)
    f64 = dict(dtype=torch.float64)
    if args.ts_tv != "e" and "kappa" in params:
        params["kappa"] = torch.tensor(float(args.ts_tv), **f64)
    if args.alpha != "e" and "alpha" in params:
        params["alpha"] = torch.tensor(float(args.alpha), **f64)
    if args.pinv != "e" and model.invar:
        params["pinv"] = torch.tensor(float(args.pinv), **f64)
    return params


def run_analysis(args) -> int:
    unported = _unported(args)
    if unported:
        for flag, item in unported:
            print(f"!! {flag}: not ported to phyml_tpu_torch yet "
                  f"(ROADMAP.md {item})", file=sys.stderr)
        return 2
    if args.platform == "gpu":
        if not torch.cuda.is_available():
            print("!! --platform gpu: no CUDA device found; run with "
                  "--platform cpu instead", file=sys.stderr)
            return 1
        device = torch.device("cuda")
    else:
        device = torch.device("cpu")
    # dtype rule: float32 on the card, float64 on the CPU unless
    # --float32
    dtype = torch.float32 if (args.float32 or device.type == "cuda") \
        else torch.float64

    from phyml_tpu_torch.io.alignment import read_alignment

    seed = args.r_seed if args.r_seed is not None else int(
        time.time()) % (2 ** 31)
    if args.datatype == "gen":
        args.datatype = "generic"
    rng = np.random.default_rng(seed)
    aln = read_alignment(args.input, datatype=args.datatype,
                         interleaved=not args.sequential)
    return _run_dataset(args, aln, rng, seed, device, dtype)


def _search(args, engine, model, params, topo, rng, seed, opt_rates,
            constraint=None, trace=None):
    """The topology search of `-o` with `t` (reference
    phyml_tpu/cli.py:463-503): `-s BEST` runs both strategies and keeps
    the better tree (cl.c: "BEST: best of NNI and SPR search");
    --rand_start repeats the search from --n_rand_starts random
    starting trees (random resolutions of the constraint tree, if any)
    and keeps the best final lnL (main.c:126-139, 308-312).  The
    constraint's predicate and the trace writer go to every search.
    Returns (topo, params, lnL)."""
    from phyml_tpu_torch.search.driver import ml_search
    from phyml_tpu_torch.topology import Topology

    kinds = ["NNI", "SPR"] if args.search == "BEST" else [args.search]
    if args.rand_start:
        starts = [constraint.random_resolution(rng) if constraint is not None
                  else Topology.random(engine.n_otu, rng)
                  for _ in range(max(1, args.n_rand_starts))]
    else:
        starts = [topo]
    best = None
    for si, topo0 in enumerate(starts):
        for kind in kinds:
            if not args.quiet and (len(starts) > 1 or len(kinds) > 1):
                print(f". Search {kind}, start {si + 1}/{len(starts)}:")
            cand = ml_search(
                engine, model, dict(params), topo0.copy(),
                kind=kind.lower(), retries=2, opt_params=opt_rates,
                seed=seed, verbose=not args.quiet, trace=trace,
                accept_topo=None if constraint is None
                else constraint.is_compatible,
                tol=args.min_diff_lk_global,
                five_branch=not args.no_five_branch)
            if best is None or cand[2] > best[2]:
                best = cand
    return best


def _supports(args, engine, model, params, topo, seed):
    """Branch supports of the final tree (reference phyml_tpu/cli.py:
    518-556): `-b N` bootstraps N replicates (serial, each re-running
    the search, SPR for `-s SPR|BEST`; or `--rapid_boot`, all
    replicates batched with the parameters frozen), reported as
    replicate counts; `-b -1/-2/-3/-4/-5` the aLRT statistic, its chi2
    support, SH-aLRT and aBayes.  Returns (support or None, format)."""
    from phyml_tpu_torch.search import support as sup

    b = args.bootstrap
    if b > 0:
        kw = dict(n_replicates=b, seed=seed,
                  bayesian=args.bayesian_bootstrap, tbe=args.tbe,
                  verbose=not args.quiet)
        if args.rapid_boot:
            support = sup.bootstrap_supports_batched(
                engine, model, params, topo, **kw)
        else:
            support = sup.bootstrap_supports(
                engine, model, params, topo,
                search="spr" if args.search in ("SPR", "BEST") else "nni",
                **kw)
        return {eid: v * b for eid, v in support.items()}, "%.0f"
    if b < 0:
        method = {-1: "alrt-stat", -2: "alrt-chi2", -3: "alrt-chi2",
                  -4: "sh", -5: "abayes"}[b]
        support = sup.alrt_supports(engine, model, params, topo,
                                    method=method, seed=seed)
        return support, "%.6f" if b == -1 else "%.4f"
    return None, "%.2f"


def _run_dataset(args, aln, rng, seed, device, dtype) -> int:
    from phyml_tpu_torch.io.output import (
        format_stats, write_results, write_site_lnl,
    )
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.ops.parsimony import parsimony_score
    from phyml_tpu_torch.optim.round import round_optimize
    from phyml_tpu_torch.topology import Topology

    t_start = time.time()

    # duplicate-sequence removal (Remove_Duplicates utilities.c:2675;
    # re-inserted in the output tree as in main.c:389)
    dup_name_pairs: list[tuple[str, str]] = []
    dup_indices: list[int] = []
    orig_names = list(aln.names)
    if not args.leave_duplicates and aln.n_otu >= 4:
        from phyml_tpu_torch.io.alignment import (
            drop_taxa, find_duplicate_taxa,
        )
        pairs = find_duplicate_taxa(aln)
        if pairs and aln.n_otu - len(pairs) >= 4:
            for d, k in pairs:
                if not args.quiet:
                    print(f". Note: taxon '{aln.names[d]}' is a "
                          f"duplicate of taxon '{aln.names[k]}'.")
                dup_name_pairs.append((aln.names[d], aln.names[k]))
            dup_indices = [d for d, _ in pairs]
            aln = drop_taxa(aln, dup_indices)

    if not args.quiet:
        print(f". {aln.n_patterns} patterns found (out of a total of "
              f"{aln.n_sites} sites).")

    model = _build_model(args, aln)
    params = _init_params(args, model, aln)
    engine = LikelihoodEngine(aln, model, dtype=dtype, device=device)

    # ---- topological constraint (reference --constraint_file) ---------
    constraint = None
    if args.constraint_file:
        from phyml_tpu_torch.search.constraint import Constraint
        constraint = Constraint.from_file(args.constraint_file, aln.names)

    # ---- starting tree ------------------------------------------------
    if args.user_tree:
        with open(args.user_tree) as fh:
            user_nwk = fh.read()
        if dup_indices:
            topo = Topology.from_newick(user_nwk, orig_names) \
                .without_leaves(set(dup_indices))
        else:
            topo = Topology.from_newick(user_nwk, aln.names)
        if constraint is not None and not constraint.is_compatible(topo):
            print("!! the user tree violates the constraint tree",
                  file=sys.stderr)
            return 1
        start_desc = f"user tree ({args.user_tree})"
    elif constraint is not None:
        topo = constraint.random_resolution(rng)
        start_desc = f"constraint resolution ({args.constraint_file})"
    elif args.rand_start:
        topo = Topology.random(aln.n_otu, rng)
        start_desc = "random"
    elif args.pars_start:
        from phyml_tpu_torch.search.stepwise import stepwise_addition_tree
        topo = stepwise_addition_tree(aln, rng)
        start_desc = "stepwise-addition parsimony"
    else:
        from phyml_tpu_torch.search.bionj import bionj_start
        topo = bionj_start(engine, params)
        start_desc = "BioNJ"

    # ---- optimize -----------------------------------------------------
    opt_topo = "t" in args.optimize
    opt_len = "l" in args.optimize or opt_topo
    opt_rates = "r" in args.optimize
    run_id = f"_{args.run_id}" if args.run_id else ""
    prefix = f"{args.input}{run_id}"
    trace = None
    if args.print_trace or args.json_trace:
        from phyml_tpu_torch.io.output import TraceWriter
        trace = TraceWriter(
            aln.names,
            newick_path=(f"{prefix}_phyml_trace.txt"
                         if args.print_trace else None),
            json_path=(f"{prefix}_phyml_trace.json"
                       if args.json_trace else None))
    if opt_topo:
        topo, params, lnl = _search(args, engine, model, params, topo, rng,
                                    seed, opt_rates, constraint, trace)
        search_desc = args.search
    else:
        search_desc = "none"
        ta = tree_arrays(topo.rooted(), dtype=dtype, device=device)
        if opt_len or opt_rates:
            params, ta, lnl = round_optimize(
                engine, model, params, ta,
                opt_blen=opt_len, opt_params=opt_rates,
                verbose=not args.quiet,
            )
        else:
            lnl = float(engine.loglik(params, ta))
        rv = topo.rooted()
        topo.set_blen_from_rooted(rv, ta.blen.double().cpu().numpy())

    support, support_fmt = _supports(args, engine, model, params, topo,
                                     seed)

    # ---- outputs ------------------------------------------------------
    stats = format_stats(
        input_name=args.input, aln=aln, model=model, params=params,
        lnl=lnl, topo=topo, search_desc=search_desc,
        start_tree_desc=start_desc, runtime_s=time.time() - t_start,
        seed=seed, n_parsimony=parsimony_score(engine, topo),
    )
    tree_path, stats_path = write_results(
        prefix, topo, aln.names, stats, support=support,
        support_fmt=support_fmt, append=args.append,
    )
    if dup_name_pairs:
        from phyml_tpu_torch.io.newick import insert_duplicate_leaves
        with open(tree_path) as fh:
            full = insert_duplicate_leaves(fh.read(), dup_name_pairs)
        with open(tree_path, "w") as fh:
            fh.write(full + "\n")
    if args.print_site_lnl:
        ta = tree_arrays(topo.rooted(), dtype=dtype, device=device)
        write_site_lnl(f"{prefix}_phyml_lk.txt", aln,
                       engine.site_logliks(params, ta))
    if not args.quiet:
        print(f". Log-likelihood: {lnl:.5f}")
        print(f". Results written to {tree_path} and {stats_path}")
    return 0


def main(argv=None) -> int:
    real_argv = sys.argv[1:] if argv is None else argv
    if not real_argv:
        print("!! the interactive menu is not ported to phyml_tpu_torch "
              f"yet (ROADMAP.md {_TOOLS}); give the options on the "
              "command line", file=sys.stderr)
        return 2
    return run_analysis(build_parser().parse_args(real_argv))


if __name__ == "__main__":
    sys.exit(main())
