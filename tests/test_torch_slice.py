"""The whole slice on the CPU: both CLIs on the same fixed-topology fit.

A 16-taxon x 500-site GTR+G4 alignment is simulated with
phyml_tpu.evolve and written, with the true tree, into two
directories; phyml_tpu.cli and phyml_tpu_torch.cli run the same flags
in float64 on the CPU.  Tolerances: final lnL 1e-3 absolute; model
parameters and branch lengths 1e-2 relative (branch lengths also 1e-4
absolute, for the ones at the 1e-8 floor).  Both runs use the same
algorithms in float64, so they agree far inside these bounds.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu import cli as jcli
from phyml_tpu.evolve import simulate_alignment, write_phylip
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.topology import Topology
from phyml_tpu_torch import cli as tcli

LNL_TOL = 1e-3
REL_TOL = 1e-2


def _write(dirname, names, seqs, newick):
    aln = dirname / "aln.phy"
    tree = dirname / "tree.nwk"
    write_phylip(str(aln), names, seqs)
    tree.write_text(newick + "\n")
    return str(aln), str(tree)


def _stats(aln_path):
    text = open(f"{aln_path}_phyml_stats.txt").read()
    out = {"lnl": float(re.search(r"Log-likelihood:\s+(\S+)", text)[1])}
    m = re.search(r"Gamma shape parameter:\s+(\S+)", text)
    if m:
        out["alpha"] = float(m[1])
    out["rr"] = [float(x) for x in
                 re.findall(r"[ACGT] <-> [ACGT]\s+(\S+)", text)]
    return out


def _blens(aln_path, names):
    from phyml_tpu_torch.topology import Topology as TTopology
    text = open(f"{aln_path}_phyml_tree.txt").read()
    return TTopology.from_newick(text, names).blen


@pytest.mark.parametrize("flags", [
    ["-o", "lr", "-a", "e"],
    ["-o", "l", "-v", "0.25", "--print_site_lnl"],
], ids=["lr-gamma", "l-invar"])
def test_cli_fixed_topology_fit(tmp_path, flags):
    rng = np.random.default_rng(11)
    topo = Topology.random(16, rng, mean_blen=0.1)
    model = JModel(datatype="nt", name="GTR", n_classes=4,
                   freqs_mode="fixed",
                   fixed_freqs=np.array([0.3, 0.2, 0.3, 0.2]))
    p = model.init_params()
    p["rr_val"] = jnp.log(jnp.asarray([1.2, 3.0, 0.8, 1.1, 4.0, 1.0]))
    p["alpha"] = jnp.asarray(0.7)
    names, seqs = simulate_alignment(topo, model, p, 500, rng)
    newick = topo.to_newick(names)

    runs = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / tag
        d.mkdir()
        aln, tree = _write(d, names, seqs, newick)
        argv = ["-i", aln, "-u", tree, "-m", "GTR", "-c", "4", *flags,
                "-b", "0", "--platform", "cpu", "--r_seed", "1",
                "--quiet"]
        assert main(argv) == 0
        runs[tag] = (_stats(aln), _blens(aln, names))
        if "--print_site_lnl" in flags:
            runs[tag + "_lk"] = np.loadtxt(f"{aln}_phyml_lk.txt",
                                           skiprows=1)

    (sj, bj), (st, bt) = runs["jax"], runs["torch"]
    assert abs(st["lnl"] - sj["lnl"]) < LNL_TOL, (st["lnl"], sj["lnl"])
    if "alpha" in sj:
        np.testing.assert_allclose(st["alpha"], sj["alpha"], rtol=REL_TOL)
    np.testing.assert_allclose(st["rr"], sj["rr"], rtol=REL_TOL)
    np.testing.assert_allclose(bt, bj, rtol=REL_TOL, atol=1e-4)
    if "--print_site_lnl" in flags:
        # per-site lnL of the fitted trees, printed to 6 decimals
        np.testing.assert_allclose(runs["torch_lk"], runs["jax_lk"],
                                   rtol=0, atol=1e-4)


def test_gpu_platform_without_cuda_names_cpu(tmp_path, capsys,
                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    aln = tmp_path / "aln.phy"
    aln.write_text(" 4 4\nA  ACGT\nB  ACGA\nC  ACTT\nD  AGGT\n")
    tree = tmp_path / "tree.nwk"
    tree.write_text("((A,B),C,D);\n")
    assert tcli.main(["-i", str(aln), "-u", str(tree), "-o", "l"]) == 1
    assert "--platform cpu" in capsys.readouterr().err


def test_unported_flags_stop_the_run(tmp_path, capsys):
    """Flags of later slices stop the port's CLI with a pointer to the
    ROADMAP item that ports them."""
    aln = tmp_path / "aln.phy"
    aln.write_text(" 4 4\nA  ACGT\nB  ACGA\nC  ACTT\nD  AGGT\n")
    assert tcli.main(["-i", str(aln), "--distributed", "--platform",
                      "cpu"]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and "--distributed" in err
