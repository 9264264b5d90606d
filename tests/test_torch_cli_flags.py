"""The CLI flags of the last data and model options, and the
checkpoint, against phyml_tpu.cli on the CPU.

Each case runs both CLIs on the same files (simulated by phyml_tpu;
tests/test_torch_bionj.py's problems at 8 taxa) in float64 and holds
the port to the same trees (RF 0, every data set) and the same final
lnL within 1e-6:

* `-d aa -m LG4X` (the default run: BioNJ, then the NNI search) and
  `--aa_rate_file` (a PAML file written from `lg4x_1`, `-o lr` on the
  BioNJ tree);
* on DNA (GTR+G4, the default run): `-n 2` (two data sets in one file:
  both append to the same tree and stats files), `--weights` (a
  per-site weight file), `--codpos 2`, `--no_gap` (sites with gaps and
  ambiguity codes), `--datatype_guess` (no `-d`) and `--il`;
* `--checkpoint`: a run writes the checkpoint at the end of the search
  and a second run resumes from it, in each package; a checkpoint
  written by phyml_tpu resumes in the port to the same stage, the same
  parameters and the same final lnL as phyml_tpu's own resume.
"""

import numpy as np
import pytest
import torch

from phyml_tpu import cli as jcli
from phyml_tpu.models import matrices as jmat
from phyml_tpu.topology import Topology
from phyml_tpu_torch import cli as tcli
from phyml_tpu_torch.utils.checkpoint import Checkpointer
from test_torch_bionj import _simulate, _stats_lnl
from test_torch_mixture import write_paml

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


def _write_sets(path, sets):
    """One PHYLIP file holding each (names, seqs) data set in turn."""
    text = []
    for names, seqs in sets:
        text.append(f" {len(names)} {len(seqs[0])}")
        text += [f"{nm:<10s}  {sq}" for nm, sq in zip(names, seqs)]
        text.append("")
    path.write_text("\n".join(text) + "\n")


def _run(main, d, argv, monkeypatch, module, names):
    """One CLI run in d: (lnL of every data set, trees of every data set,
    the stats file's text)."""
    seen = _stats_lnl(monkeypatch, module)
    assert main(argv) == 0
    aln = argv[argv.index("-i") + 1]
    with open(f"{aln}_phyml_tree.txt") as fh:
        trees = [Topology.from_newick(ln, names) for ln in fh if ln.strip()]
    with open(f"{aln}_phyml_stats.txt") as fh:
        return seen, trees, fh.read()


def run_both(tmp_path, monkeypatch, files, argv, names,
             tags=("jax", "torch")):
    """Both CLIs, each in its own directory holding `files` (name ->
    text, or (names, seqs) data sets for a PHYLIP file); `argv` names
    them, and the checkpoint `ck.npz`, by file name.  Returns {tag:
    _run's triple}."""
    import phyml_tpu.io.output as jout
    import phyml_tpu_torch.io.output as tout

    out = {}
    for tag in tags:
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        for fname, content in files.items():
            if isinstance(content, str):
                (d / fname).write_text(content)
            else:
                _write_sets(d / fname, content)
        args = [str(d / a) if a in files or a == "ck.npz" else a
                for a in argv]
        main, mod = (jcli.main, jout) if tag == "jax" else (tcli.main, tout)
        out[tag] = _run(main, d, args + ["--platform", "cpu", "--r_seed",
                                         "1", "--quiet"],
                        monkeypatch, mod, names)
    return out


def _same(runs, n_sets=1):
    (jl, jt, _), (tl, tt, _) = runs["jax"], runs["torch"]
    assert len(jl) == len(tl) == len(jt) == len(tt) == n_sets
    for a, b in zip(jt, tt):
        assert b.rf_distance(a) == 0
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LNL_TOL)


@pytest.mark.parametrize("case", ["lg4x", "aa_rate_file"])
def test_protein_models_match_phyml_tpu(case, tmp_path, monkeypatch):
    names, seqs, _ = _simulate("aa", **SIZE)
    files = {"aln.phy": [(names, seqs)]}
    if case == "lg4x":
        argv = ["-i", "aln.phy", "-d", "aa", "-m", "LG4X", "-b", "0"]
    else:
        rates = str(tmp_path / "lg4x_1.dat")
        write_paml(rates, *jmat.empirical_aa("lg4x_1"))
        argv = ["-i", "aln.phy", "-d", "aa", "-m", "LG", "--aa_rate_file",
                rates, "-c", "4", "-a", "e", "-o", "lr", "-b", "0"]
    runs = run_both(tmp_path, monkeypatch, files, argv, names)
    _same(runs)
    stats = runs["torch"][2]
    if case == "lg4x":
        assert "LG4X" in stats and "FreeRate mixture" in stats
    else:
        assert "CUSTOMAA" in stats


def _dna(seed=5):
    names, seqs, _ = _simulate("nt", seed=seed, **SIZE)
    return names, seqs


@pytest.mark.parametrize("case", ["n2", "weights", "codpos", "no_gap",
                                  "datatype_guess", "il"])
def test_dna_flags_match_phyml_tpu(case, tmp_path, monkeypatch):
    names, seqs = _dna()
    sets = [(names, seqs)]
    argv = ["-i", "aln.phy", "-m", "GTR", "-c", "4", "-b", "0"]
    files = {}
    n_sets = 1
    if case == "n2":
        sets.append(_dna(seed=6))
        argv += ["-n", "2"]
        n_sets = 2
    elif case == "weights":
        w = np.random.default_rng(3).integers(0, 4, len(seqs[0]))
        files["w.txt"] = " ".join(str(x) for x in w) + "\n"
        argv += ["--weights", "w.txt"]
    elif case == "codpos":
        argv += ["--codpos", "2"]
    elif case == "no_gap":
        rng = np.random.default_rng(4)
        seqs = ["".join(c if rng.random() > 0.03 else rng.choice(list("-NRY"))
                        for c in s) for s in seqs]
        sets = [(names, seqs)]
        argv += ["--no_gap"]
    elif case == "datatype_guess":
        argv += ["--datatype_guess"]
    else:
        argv += ["--il", "-o", "lr"]
    if case != "datatype_guess":
        argv += ["-d", "nt"]
    files["aln.phy"] = sets
    runs = run_both(tmp_path, monkeypatch, files, argv, names)
    _same(runs, n_sets)
    stats = runs["torch"][2]
    assert stats.count(". Log-likelihood:") == n_sets
    if case == "il":
        assert "IL variance parameter sigma" in stats


def test_checkpoint_writes_and_resumes(tmp_path, monkeypatch):
    """Each package: the first run saves its result at stage
    search_done; a second run resumes from it and ends where it did."""
    names, seqs = _dna()
    argv = ["-i", "aln.phy", "-m", "GTR", "-c", "4", "-b", "0",
            "--checkpoint", "ck.npz"]
    files = {"aln.phy": [(names, seqs)]}
    first = run_both(tmp_path, monkeypatch, files, argv, names)
    _same(first)
    for tag in ("jax", "torch"):
        assert Checkpointer(str(tmp_path / tag / "ck.npz")).resume()[2] \
            == "search_done"
    # the second run: the checkpoint stays, the data are rewritten
    again = run_both(tmp_path, monkeypatch, files, argv, names)
    _same(again)
    for tag in ("jax", "torch"):
        assert abs(again[tag][0][0] - first[tag][0][0]) < 1e-3
        assert again[tag][1][0].rf_distance(first[tag][1][0]) == 0


def test_checkpoint_of_phyml_tpu_resumes_in_the_port(tmp_path, monkeypatch):
    """A checkpoint written by phyml_tpu.cli: the port reads the same
    stage, topology and parameters (float64 host tensors), and its run
    from it ends at phyml_tpu's own resumed run's tree and lnL."""
    from phyml_tpu.utils.checkpoint import Checkpointer as JCheckpointer

    names, seqs = _dna()
    files = {"aln.phy": [(names, seqs)]}
    argv = ["-i", "aln.phy", "-m", "GTR", "-c", "4", "-a", "e", "-b", "0",
            "--checkpoint", "ck.npz"]
    run_both(tmp_path, monkeypatch, files, argv, names, tags=("jax",))
    ck = tmp_path / "jax" / "ck.npz"
    (tmp_path / "torch").mkdir()
    (tmp_path / "torch" / "ck.npz").write_bytes(ck.read_bytes())
    jtopo, jparams, jstage = JCheckpointer(str(ck)).resume()
    ttopo, tparams, tstage = Checkpointer(str(ck)).resume()
    assert tstage == jstage == "search_done"
    np.testing.assert_array_equal(ttopo.edges, jtopo.edges)
    np.testing.assert_array_equal(ttopo.blen, jtopo.blen)
    assert set(tparams) == set(jparams)
    for k, v in tparams.items():
        assert v.dtype == torch.float64 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]))
    runs = run_both(tmp_path, monkeypatch, files, argv, names)
    _same(runs)
