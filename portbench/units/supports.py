"""Supports of every internal edge on one fit.  Set-up fits the model
once through the port's own calls, as the CLI's `-o lr` path does
(options from the traffic's `setup_argv`); `run()` is one
`alrt_supports` call on that fit with the traffic's `method`.  It
returns the supports and, for the comparison, the NNI scorer's three
lnL of every internal edge, taken from the call inside it; `record` is
the set-up fit."""

from __future__ import annotations

import numpy as np

from portbench import units


class Unit:
    def __init__(self, traffic, config, aln, tree, platform, r_seed):
        self.argv = units.fill(traffic["setup_argv"], aln, tree, config,
                               platform, r_seed)
        self.method = traffic["method"]
        self.r_seed = r_seed
        self.record = None

    def setup(self):
        """The fit of the CLI's `-o lr` path (cli.py:_run_dataset),
        through the same calls."""
        import torch

        from phyml_tpu_torch import cli
        from phyml_tpu_torch.io.alignment import read_alignment
        from phyml_tpu_torch.ops.likelihood import (
            LikelihoodEngine, tree_arrays,
        )
        from phyml_tpu_torch.optim.round import round_optimize
        from phyml_tpu_torch.topology import Topology

        args = cli.build_parser().parse_args(self.argv)
        device = cli._device(args)
        if device is None:
            raise RuntimeError("no device for --platform "
                               f"{args.platform}")
        dtype = torch.float32 if device.type == "cuda" else torch.float64
        aln = read_alignment(args.input, datatype=args.datatype)
        model = cli._build_model(args, aln)
        params = cli._init_params(args, model, aln)
        engine = LikelihoodEngine(aln, model, dtype=dtype, device=device)
        with open(args.user_tree) as fh:
            topo = Topology.from_newick(fh.read(), aln.names)
        rv = topo.rooted()
        ta = tree_arrays(rv, dtype=dtype, device=device)
        params, ta, lnl = round_optimize(
            engine, model, params, ta, opt_blen="l" in args.optimize,
            opt_params="r" in args.optimize)
        topo.set_blen_from_rooted(rv, ta.blen.double().cpu().numpy())
        self.state = (engine, model, params, topo)
        self.record = {"fit": units.fit_record(lnl, params, topo)}

    def run(self) -> dict:
        from phyml_tpu_torch.search import support

        engine, model, params, topo = self.state
        seen = []

        def keep(orig):
            def nni_scores(*a, **kw):
                out = orig(*a, **kw)
                seen.append((np.asarray(a[3]).copy(),
                             np.asarray(out[0], dtype=np.float64).copy()))
                return out
            return nni_scores

        with units.patched(support, "nni_scores", keep):
            sup = support.alrt_supports(engine, model, params, topo,
                                        method=self.method,
                                        seed=self.r_seed)
        if len(seen) != 1:
            raise RuntimeError(f"{len(seen)} scorer calls in one unit")
        cand, lnl = seen[0]
        return {"supports": {int(k): float(v) for k, v in sup.items()},
                "cand": cand.astype(np.int64), "nni_lnl": lnl}

    def free(self):
        self.state = None
