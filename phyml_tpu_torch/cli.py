"""Command-line front end, mirroring the reference's phyml CLI.

Reference: Read_Command_Line (cl.c:19) and the per-dataset
loop (main.c:108-434).  The parser takes the same flags as
phyml_tpu's; this port runs the `phyml` ML run on DNA and on amino
acids (LG, WAG, JTT and the other empirical matrices, LG4X and a
PAML rate file through `--aa_rate_file`): the start tree
(`-u` tree, `--rand_start`, `--pars_start`, a resolution of
`--constraint_file`, else ML distances and BioNJ), the topology search
(`-o` with `t`, `-s NNI|SPR|BEST`, `--n_rand_starts`,
`--min_diff_lk_global`, `--no_five_branch`, `--constraint_file`,
`--print_trace`, `--json_trace`) or the fixed-topology fit (`-o` in
{l, r, lr, n/''}), branch supports (`-b N` bootstrap with `--tbe`,
`--bayesian_bootstrap`, `--rapid_boot`; `-b -1/-2/-3/-4/-5` aLRT,
SH-aLRT and aBayes), the model and data flags (`--il`, `--codpos`,
`--weights`, `--no_gap`, `-n` data sets), the covarion model (`--cov`,
`--cov_delta`, `--cov_alpha`, `--cov_ncats`, `--cov_free`), custom
alphabets (`-d generic`), `--checkpoint`, `--print_site_lnl`, the
auxiliary tools on the final tree (`--ps`, `--cv tip|kfold.col|
kfold.pos`, `--ancestral`, `--mutmap`, `--alias_subpatt`), and `--xml`
analyses (io/xmlcfg.py: mixtures, partitions, phytime and phyrex).  With no
arguments it opens the interactive menu (interface.py).  `--distributed`
joins the process group `torchrun` describes (parallel/boot.py): every
rank runs the analysis, `-b N` farms the replicates over the ranks, and
rank 0 alone prints and writes the outputs.  `--profile_out PATH` runs
the whole command under `torch.profiler` (the CPU, and the card on
`--platform gpu`) and writes its Chrome trace to PATH: the program's
`phyml.*` spans (utils/trace.py) beside every operation, and the run's
counters under the trace's `phyml_counters` key.

    python -m phyml_tpu_torch.cli -i aln.phy -m GTR -c 4 -b 0 \\
        --platform gpu                       # BioNJ, then NNI search
    python -m phyml_tpu_torch.cli -i aln.phy -m GTR -c 4 -b -5 \\
        --platform gpu                       # ... then aBayes supports
    python -m phyml_tpu_torch.cli -i prot.phy -u tree.nwk -d aa -m LG \\
        -c 4 -a e -o lr -b 0 --platform gpu
    python -m phyml_tpu_torch.cli -i prot.phy -d aa -m LG4X -b 0 \\
        --platform gpu                       # the LG4X mixture
    python -m phyml_tpu_torch.cli -i aln.phy -m GTR -c 4 --cov \\
        --cov_ncats 3 --cov_delta e -b 0 --platform gpu   # covarion
    python -m phyml_tpu_torch.cli -i binary.phy -d generic -c 4 -b 0 \\
        --platform gpu                       # a custom alphabet
    python -m phyml_tpu_torch.cli -i aln.phy -u tree.nwk -m GTR -c 4 \\
        -o lr --ancestral --cv tip --ps --platform gpu   # the tools
    python -m phyml_tpu_torch.cli --xml run.xml --platform gpu
    python -m phyml_tpu_torch.cli            # the interactive menu
    torchrun --nproc_per_node 2 -m phyml_tpu_torch.cli --distributed \
        -i aln.phy -m GTR -c 4 -b 100 --platform gpu   # farmed bootstrap
    python -m phyml_tpu_torch.cli -i aln.phy -m GTR -c 4 -b -5 \
        --platform gpu --profile_out run.json   # a profiler trace
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from phyml_tpu_torch.utils import trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phyml-tpu-torch",
        description="PyTorch/CUDA phylogenetic ML (PhyML-compatible CLI)",
    )
    p.add_argument("-i", "--input", default=None,
                   help="PHYLIP/FASTA/NEXUS alignment (required "
                        "unless --xml)")
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
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run via torch.distributed (the "
                        "environment torchrun sets): bootstrap replicates "
                        "farmed over the ranks, rank 0 writes")
    p.add_argument("--weights", default=None,
                   help="site-weight file")
    # covarion (M4) family; the reference's --cov CLI (cl.c:69-74) is
    # bit-rotted upstream (see tests/test_covarion.py) but phyml_tpu
    # keeps the option surface, and so does this port
    p.add_argument("--cov", action="store_true",
                   help="covarion (M4) model: hidden rate classes "
                        "with switching")
    p.add_argument("--cov_delta", default=None,
                   help="switching rate (value, or 'e' to estimate)")
    p.add_argument("--cov_alpha", default=None,
                   help="gamma shape of hidden-class rates (value or "
                        "'e'); selects the --cov_alpha mode")
    p.add_argument("--cov_ncats", type=int, default=3,
                   help="number of hidden rate classes")
    p.add_argument("--cov_free", action="store_true",
                   help="free hidden-class rates and frequencies")
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
    p.add_argument("--xml", default=None,
                   help="XML analysis description (partitions/mixtures)")
    p.add_argument("--datatype_guess", action="store_true")
    p.add_argument("--float32", action="store_true",
                   help="fp32 likelihood (default on the GPU; fp64 on "
                        "the CPU)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; resumes if it exists")
    p.add_argument("--checkpoint_every", type=int, default=300,
                   help="checkpoint interval, seconds")
    p.add_argument("--profile_out", default=None,
                   help="write a torch.profiler Chrome trace of the run, "
                        "with the program's spans and counters, here")
    return p


def _build_model(args, aln):
    from phyml_tpu_torch.models.substitution import SubstModel, lg4x_model

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
    if name.upper() == "LG4X":
        return lg4x_model()
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
    use_cov = (args.cov or args.cov_free or args.cov_delta is not None
               or args.cov_alpha is not None)
    cov_mode = "fixed"
    if args.cov_free:
        cov_mode = "free"
    elif args.cov_alpha is not None:
        cov_mode = "alpha"
    custom_aa = None
    if args.aa_rate_file:
        from phyml_tpu_torch.models.matrices import read_paml_matrix
        custom_aa = read_paml_matrix(args.aa_rate_file)
        name = "CUSTOMAA"
    return SubstModel(
        datatype=aln.datatype,
        name=name,
        custom_aa=custom_aa,
        n_classes=args.n_classes,
        invar=(args.pinv == "e" or float(args.pinv or 0) > 0),
        freerate=args.free_rates,
        freqs_mode=freqs_mode,
        fixed_freqs=fixed,
        covarion=use_cov,
        n_hidden=args.cov_ncats,
        cov_mode=cov_mode,
        optimize_kappa=opt_r and args.ts_tv == "e",
        optimize_alpha=opt_r and args.alpha == "e",
        optimize_pinv=opt_r and args.pinv == "e",
        optimize_rr=opt_r,
        optimize_cov=opt_r and (args.cov_delta == "e"
                                or args.cov_alpha == "e"
                                or args.cov_free),
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
    if model.covarion:
        if args.cov_delta not in (None, "e"):
            params["cov_delta"] = torch.tensor(float(args.cov_delta), **f64)
        if args.cov_alpha not in (None, "e") and "cov_alpha" in params:
            params["cov_alpha"] = torch.tensor(float(args.cov_alpha), **f64)
    if args.il:
        # IL branch-length variance sigma, stored in log space and
        # optimized with the other scalars (reference default 0.1,
        # init.c:693); the engine substitutes the MGF eigenvalues in
        # _system, so every search/optimizer path is exact under IL
        params["il_sigma"] = torch.tensor(float(np.log(0.1)), **f64)
    return params


def _device(args):
    """The device --platform names, or None (with a message) when it
    names the GPU and there is none."""
    if args.platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("!! --platform gpu: no CUDA device found; run with "
              "--platform cpu instead", file=sys.stderr)
        return None
    return torch.device("cuda")


def run_analysis(args) -> int:
    device = _device(args)
    if device is None:
        return 1
    if not args.distributed:
        return _run_all(args, device)
    import torch.distributed as dist

    from phyml_tpu_torch.parallel.boot import initialize_distributed

    # before the alignment is read (phyml_tpu/cli.py:308-314); a group
    # the caller already joined is used as it is
    owned = not dist.is_initialized()
    pid, nproc = initialize_distributed(on_card=device.type == "cuda")
    if pid != 0:
        args.quiet = True
    if not args.quiet:
        print(f". Distributed run: process {pid} of {nproc}.")
        if dist.is_initialized():
            print(f". Collective backend: {dist.get_backend()}.")
    try:
        return _run_all(args, device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _run_all(args, device) -> int:
    # dtype rule: float32 on the card, float64 on the CPU unless
    # --float32
    dtype = torch.float32 if (args.float32 or device.type == "cuda") \
        else torch.float64

    from phyml_tpu_torch.io.alignment import (
        read_alignment, read_alignments_multi, read_site_weights,
    )

    seed = args.r_seed if args.r_seed is not None else int(
        time.time()) % (2 ** 31)
    rng = np.random.default_rng(seed)
    site_w = read_site_weights(args.weights) if args.weights else None
    if args.datatype == "gen":
        args.datatype = "generic"
    with trace.span("cli.read"):
        if args.multiple > 1:
            alns = read_alignments_multi(
                args.input, args.multiple, datatype=args.datatype,
                interleaved=not args.sequential, site_weights=site_w)
        else:
            alns = [read_alignment(args.input, datatype=args.datatype,
                                   interleaved=not args.sequential,
                                   site_weights=site_w, codpos=args.codpos)]
        if args.no_gap:
            from phyml_tpu_torch.io.alignment import (
                remove_ambiguous_patterns,
            )
            alns = [remove_ambiguous_patterns(a) for a in alns]
    rc = 0
    for set_idx, aln in enumerate(alns):
        if len(alns) > 1 and not args.quiet:
            print(f"\n. Data set #{set_idx + 1} of {len(alns)}.")
        rc |= _run_dataset(args, aln, rng, seed, device, dtype, set_idx,
                           len(alns))
    return rc


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
    the search, SPR for `-s SPR|BEST`; farmed over the ranks of a
    `--distributed` run of several processes, which takes precedence;
    or `--rapid_boot`, all replicates batched with the parameters
    frozen), reported as replicate counts; `-b -1/-2/-3/-4/-5` the
    aLRT statistic, its chi2 support, SH-aLRT and aBayes.  Returns
    (support or None, format)."""
    from phyml_tpu_torch.parallel.boot import (
        process_layout, run_bootstrap_distributed,
    )
    from phyml_tpu_torch.search import support as sup

    b = args.bootstrap
    if b > 0:
        kw = dict(n_replicates=b, seed=seed,
                  bayesian=args.bayesian_bootstrap, tbe=args.tbe,
                  verbose=not args.quiet)
        search = "spr" if args.search in ("SPR", "BEST") else "nni"
        if args.distributed and process_layout()[1] > 1:
            support = run_bootstrap_distributed(
                engine, model, params, topo, search=search, **kw)
        elif args.rapid_boot:
            support = sup.bootstrap_supports_batched(
                engine, model, params, topo, **kw)
        else:
            support = sup.bootstrap_supports(
                engine, model, params, topo, search=search, **kw)
        return {eid: v * b for eid, v in support.items()}, "%.0f"
    if b < 0:
        method = {-1: "alrt-stat", -2: "alrt-chi2", -3: "alrt-chi2",
                  -4: "sh", -5: "abayes"}[b]
        support = sup.alrt_supports(engine, model, params, topo,
                                    method=method, seed=seed)
        return support, "%.6f" if b == -1 else "%.4f"
    return None, "%.2f"


def _run_dataset(args, aln, rng, seed, device, dtype, set_idx=0,
                 n_sets=1) -> int:
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

    with trace.span("cli.engine"):
        model = _build_model(args, aln)
        params = _init_params(args, model, aln)
        engine = LikelihoodEngine(aln, model, dtype=dtype, device=device)
        if device.type == "cuda":
            from phyml_tpu_torch.ops import _build
            _build.library()

    # ---- topological constraint (reference --constraint_file) ---------
    constraint = None
    if args.constraint_file:
        from phyml_tpu_torch.search.constraint import Constraint
        constraint = Constraint.from_file(args.constraint_file, aln.names)

    # ---- starting tree ------------------------------------------------
    with trace.span("cli.start"):
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

    checkpointer = None
    if args.checkpoint:
        from phyml_tpu_torch.utils.checkpoint import Checkpointer
        checkpointer = Checkpointer(args.checkpoint,
                                    every_s=args.checkpoint_every)
        resumed = checkpointer.resume()
        if resumed is not None:
            topo, params, stage = resumed
            if not args.quiet:
                print(f". Resumed from checkpoint ({stage}).")

    run_id = f"_{args.run_id}" if args.run_id else ""
    prefix = f"{args.input}{run_id}"
    # side outputs of one data set of several must not clobber
    # another's
    side = f"{prefix}_set{set_idx + 1}" if n_sets > 1 else prefix
    tracer = None
    if args.print_trace or args.json_trace:
        from phyml_tpu_torch.io.output import TraceWriter
        tracer = TraceWriter(
            aln.names,
            newick_path=(f"{side}_phyml_trace.txt"
                         if args.print_trace else None),
            json_path=(f"{side}_phyml_trace.json"
                       if args.json_trace else None))
    if opt_topo:
        with trace.span("cli.search"):
            topo, params, lnl = _search(args, engine, model, params, topo,
                                        rng, seed, opt_rates, constraint,
                                        tracer)
        search_desc = args.search
    else:
        search_desc = "none"
        with trace.span("cli.fit"):
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

    if checkpointer is not None:
        checkpointer.save(topo, params, "search_done", force=True)

    with trace.span("cli.supports"):
        support, support_fmt = _supports(args, engine, model, params, topo,
                                         seed)

    # ---- outputs ------------------------------------------------------
    from phyml_tpu_torch.parallel.boot import process_layout
    if args.distributed and process_layout()[0] != 0:
        # rank 0 writes (mpi_boot.c:282-314); every rank took part in
        # the count reduction above
        return 0
    with trace.span("cli.output"):
        il_lines = []
        if "il_sigma" in params:
            il_lines = [
                ". Integrated length (IL) model: \tyes",
                f"  - IL variance parameter sigma: \t"
                f"{float(np.exp(float(params['il_sigma']))):.5f}",
            ]
        stats = format_stats(
            input_name=args.input, aln=aln, model=model, params=params,
            lnl=lnl, topo=topo, search_desc=search_desc,
            start_tree_desc=start_desc, runtime_s=time.time() - t_start,
            seed=seed, n_parsimony=parsimony_score(engine, topo),
            extra_lines=il_lines,
        )
        # every data set after the first appends to the same two files
        tree_path, stats_path = write_results(
            prefix, topo, aln.names, stats, support=support,
            support_fmt=support_fmt, append=(set_idx > 0 or args.append),
        )
        if dup_name_pairs:
            from phyml_tpu_torch.io.newick import insert_duplicate_leaves
            with open(tree_path) as fh:
                full = insert_duplicate_leaves(fh.read(), dup_name_pairs)
            with open(tree_path, "w") as fh:
                fh.write(full + "\n")
        if args.print_site_lnl:
            ta = tree_arrays(topo.rooted(), dtype=dtype, device=device)
            write_site_lnl(f"{side}_phyml_lk.txt", aln,
                           engine.site_logliks(params, ta))
        _tools(args, engine, model, aln, params, topo, rng, seed, side)
    if not args.quiet:
        print(f". Log-likelihood: {lnl:.5f}")
        print(f". Results written to {tree_path} and {stats_path}")
    return 0


def _tools(args, engine, model, aln, params, topo, rng, seed, side):
    """The auxiliary outputs of the final tree (reference phyml_tpu/
    cli.py:597-672), each on the engine's device: `--ps` the
    PostScript drawing, `--cv tip|kfold.col|kfold.pos` cross-validation
    (`_phyml_cv.txt`), `--ancestral` the marginal posteriors and MPEE
    calls, `--mutmap` one joint draw of classes and ancestral states (a
    torch.Generator on the device seeded with the run's seed) and the
    substitution histories (numpy, seed + 31), `--alias_subpatt` the
    subpattern-aliasing report."""
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays

    device, dtype = engine.device, engine.dtype
    if args.ps:
        from phyml_tpu_torch.io.draw import write_postscript
        write_postscript(f"{side}_phyml_tree.ps", topo, aln.names,
                         title=args.input)
    if args.cv:
        from phyml_tpu_torch.io.output import write_cv
        from phyml_tpu_torch.ops import crossval
        ta = tree_arrays(topo.rooted(), dtype=dtype, device=device)
        path = f"{side}_phyml_cv.txt"
        if args.cv == "tip":
            res = crossval.tip_cv(engine, params, ta)
            write_cv(path, aln, model, "tip", res)
            if not args.quiet:
                print(f". CV score (mean log predictive prob): "
                      f"{res['score']:.6f}")
        elif args.cv == "kfold.col":
            total, folds = crossval.kfold_col_cv(
                engine, model, params, ta, rng=rng,
                verbose=not args.quiet)
            write_cv(path, aln, model, "kfold.col",
                     dict(score=total, folds=folds))
            if not args.quiet:
                print(f". CV held-out log-likelihood: {total:.4f}")
        else:
            def factory(a):
                return LikelihoodEngine(a, model, dtype=dtype, device=device)
            score, n_masked = crossval.kfold_pos_cv(
                factory, aln, model, params, ta, rng=rng)
            write_cv(path, aln, model, "kfold.pos",
                     dict(score=score, n_masked=n_masked))
            if not args.quiet:
                print(f". CV score at {n_masked} masked cells: "
                      f"{score:.4f}")
    if args.ancestral:
        from phyml_tpu_torch.io.output import write_ancestral
        from phyml_tpu_torch.ops.ancestral import marginal_posteriors
        rv = topo.rooted()
        ta = tree_arrays(rv, dtype=dtype, device=device)
        probs = marginal_posteriors(engine, params, ta)
        write_ancestral(side, aln, topo, rv, probs, aln.datatype)
    if args.mutmap:
        # one joint draw of (rate classes, ancestral states) then
        # endpoint-conditioned path sampling per (edge, site)
        # (Sample_Ancestral_Seq ancestral.c:15 + Map_Mutations :345)
        from phyml_tpu_torch.ops.ancestral import (
            map_mutations, sample_ancestral, write_mutmap,
        )
        ta = tree_arrays(topo.rooted(), dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        classes, states = sample_ancestral(engine, params, ta, gen)
        events = map_mutations(engine, params, ta, classes, states,
                               np.random.default_rng(seed + 31))
        write_mutmap(f"{side}_phyml_mutmap.txt", events)
        if not args.quiet:
            print(f". Mutation map written to {side}_phyml_mutmap.txt")
    if args.alias_subpatt:
        from phyml_tpu_torch.ops.alias import alias_stats
        rep = alias_stats(aln, np.asarray(topo.rooted().child))
        if not args.quiet:
            print(f". Subpattern aliasing: {rep}")


def main(argv=None) -> int:
    real_argv = sys.argv[1:] if argv is None else argv
    if not real_argv:
        # no options: drop into the PHYLIP-style menu, exactly like
        # the reference (Get_Input io.c:4373-4384 -> interface.c:15)
        from phyml_tpu_torch.interface import launch_interface
        return launch_interface()
    parser = build_parser()
    args = parser.parse_args(real_argv)
    if args.xml is None and args.input is None:
        parser.error("the following arguments are required: -i/--input")
    if args.profile_out:
        return _profiled(args)
    return _run_command(args)


def _run_command(args) -> int:
    if args.xml:
        from phyml_tpu_torch.io.xmlcfg import run_xml
        device = _device(args)
        if device is None:
            return 1
        return run_xml(args.xml, quiet=args.quiet, device=device)
    return run_analysis(args)


def _profiled(args) -> int:
    """The command under torch.profiler (the CPU's operations, and the
    card's on `--platform gpu`); its Chrome trace goes to
    `--profile_out` with the counters that moved during the run (their
    differences, utils/trace.py) under the key `phyml_counters`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if args.platform == "gpu" and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = trace.snapshot()
    with torch.profiler.profile(activities=acts) as prof:
        rc = _run_command(args)
        if len(acts) > 1:
            torch.cuda.synchronize()
        prof.add_metadata_json("phyml_counters",
                               json.dumps(trace.since(before)))
    prof.export_chrome_trace(args.profile_out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
