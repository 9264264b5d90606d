"""The port's CLI on the support, start-tree and trace flags against
phyml_tpu.cli, on the CPU.

Both CLIs run on the same simulated files (8 taxa x 150 sites of DNA
under GTR+G4, tests/test_torch_bionj.py::run_both_clis; the default run,
BioNJ and the NNI search, then the flag's own step) in float64:

* `-b -4` (SH-aLRT), `-b -5` (aBayes), `-b 2` (serial bootstrap),
  `-b 2 --tbe`, `-b 3 --rapid_boot`: the same tree, final lnL within
  1e-6, and the same support label on every clade of the tree file;
* `--pars_start` (stepwise-addition parsimony start), `--constraint_file`
  (a random resolution of a multifurcating constraint, then a search
  that keeps its clades): the same tree and final lnL;
* `--print_trace --json_trace` from a random start: the same trees, in
  the same order, in both trace files, and the same lnL in the JSON
  snapshots.
"""

import json

import pytest
import torch

from phyml_tpu.topology import Topology
from phyml_tpu_torch.io.newick import parse_newick
from test_torch_bionj import _simulate, run_both_clis

LNL_TOL = 1e-6
SIZE = dict(n_taxa=8, n_sites=150)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As in tests/test_torch_bionj.py: one torch thread for the many
    small ops of the search."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clade_labels(text, first):
    """{clade: support label} of a newick tree file: each internal
    node's leaf set, named by the side without taxon `first`."""
    root = parse_newick(text)
    every = set()
    out = {}

    def leaves(node):
        if node.is_leaf:
            every.add(node.name)
            return {node.name}
        below = set().union(*(leaves(c) for c in node.children))
        if node is not root:
            out[frozenset(below)] = node.support or node.name
        return below

    leaves(root)
    return {(k if first not in k else frozenset(every - k)): v
            for k, v in out.items()}


def _read(tmp_path, tag, suffix):
    with open(tmp_path / tag / f"aln.phy_phyml_{suffix}") as fh:
        return fh.read()


def _same_run(runs):
    (lj, tj), (lt, tt) = runs["jax"], runs["torch"]
    assert tt.rf_distance(tj) == 0
    assert abs(lt - lj) < LNL_TOL, (lt, lj)


@pytest.mark.parametrize("flags", [
    ["-b", "-4"], ["-b", "-5"], ["-b", "2"], ["-b", "2", "--tbe"],
    ["-b", "3", "--rapid_boot"]],
    ids=["sh", "abayes", "boot", "boot-tbe", "rapid-boot"])
def test_cli_supports_match_phyml_tpu(flags, tmp_path, monkeypatch):
    runs = run_both_clis(tmp_path, monkeypatch, "nt", flags, **SIZE)
    _same_run(runs)
    labels = {tag: _clade_labels(_read(tmp_path, tag, "tree.txt"), "T0")
              for tag in ("jax", "torch")}
    assert len(labels["torch"]) == SIZE["n_taxa"] - 3
    assert all(v for v in labels["torch"].values())
    assert labels["torch"] == labels["jax"]


def test_cli_pars_start_matches_phyml_tpu(tmp_path, monkeypatch):
    runs = run_both_clis(tmp_path, monkeypatch, "nt", ["--pars_start"],
                         **SIZE)
    _same_run(runs)
    assert "stepwise-addition parsimony" in runs["torch_stats"]


def test_cli_constraint_file_matches_phyml_tpu(tmp_path, monkeypatch):
    names, _, truth = _simulate("nt", **SIZE)
    # the simulating tree with all but two disjoint clades collapsed
    keep = []
    for bip in sorted(truth.bipartitions(), key=len):
        if len(keep) < 2 and not any(bip & k for k in keep):
            keep.append(bip)
    constraint = tmp_path / "constraint.nwk"
    rest = set(range(len(names))) - set().union(*keep)
    groups = ["(" + ",".join(names[i] for i in sorted(k)) + ")"
              for k in keep] + [names[i] for i in sorted(rest)]
    constraint.write_text("(" + ",".join(groups) + ");\n")
    runs = run_both_clis(tmp_path, monkeypatch, "nt",
                         ["--constraint_file", str(constraint)], **SIZE)
    _same_run(runs)
    assert "constraint resolution" in runs["torch_stats"]
    final = Topology.from_newick(_read(tmp_path, "torch", "tree.txt"),
                                 names)
    assert set(keep) <= set(final.bipartitions())


def test_cli_traces_match_phyml_tpu(tmp_path, monkeypatch):
    names, _, _ = _simulate("nt", **SIZE)
    # a random start, so that the search improves on it
    runs = run_both_clis(tmp_path, monkeypatch, "nt",
                         ["--rand_start", "--n_rand_starts", "1",
                          "--print_trace", "--json_trace"], **SIZE)
    _same_run(runs)
    lines = {tag: _read(tmp_path, tag, "trace.txt").split()
             for tag in ("jax", "torch")}
    assert len(lines["torch"]) == len(lines["jax"]) >= 1
    for t, j in zip(lines["torch"], lines["jax"]):
        assert Topology.from_newick(t, names).rf_distance(
            Topology.from_newick(j, names)) == 0
    snaps = {tag: json.loads(_read(tmp_path, tag, "trace.json"))
             for tag in ("jax", "torch")}
    assert len(snaps["torch"]) == len(lines["torch"])
    for t, j in zip(snaps["torch"], snaps["jax"]):
        # the snapshots' lnL is rounded to 5 decimals
        assert abs(t["state"]["lnL"] - j["state"]["lnL"]) <= 1.1e-5
        assert t["state"]["state_num"] == j["state"]["state_num"]
