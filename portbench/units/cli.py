"""One `phyml_tpu_torch.cli.main(argv)` call in process, argv the
traffic's template filled in (`units.fill`); returns the fit the run
wrote: its lnL, parameters and tree, taken at full precision from the
call that writes the statistics file."""

from __future__ import annotations

from portbench import units


class Unit:
    record = None

    def __init__(self, traffic, config, aln, tree, platform, r_seed):
        self.argv = units.fill(traffic["argv"], aln, tree, config, platform,
                               r_seed)

    def setup(self):
        pass

    def run(self) -> dict:
        from phyml_tpu_torch import cli
        from phyml_tpu_torch.io import output

        seen = []

        def keep(orig):
            def format_stats(**kw):
                seen.append(units.fit_record(kw["lnl"], kw["params"],
                                             kw["topo"]))
                return orig(**kw)
            return format_stats

        with units.patched(output, "format_stats", keep):
            rc = cli.main(list(self.argv))
        if rc != 0 or len(seen) != 1:
            raise RuntimeError(f"phyml_tpu_torch.cli.main returned {rc} "
                               f"after {len(seen)} fits")
        return {"fit": seen[0]}

    def free(self):
        pass
