"""The port's host-only tools against phyml_tpu, on the CPU: subpattern
aliasing, tree drawing, the sequence simulator (`evolve`) and the
interactive menu, and `--ps` / `--alias_subpatt` through both CLIs.

* `tip_pattern_codes`, `subpattern_ids`, `alias_compaction` and
  `alias_stats` on a simulated 12-taxon alignment with gaps: the same
  arrays and report;
* `tree_layout`, `write_postscript` and `ascii_tree`: the same
  coordinates and the same text;
* `simulate_alignment` from one seed under GTR+G4+I and LG+G4: the
  same sequences (P(t) is float64 in both, so a draw could flip only
  where a uniform falls within roundoff of a cumulative probability;
  none does on these fixtures, and SIM_AGREE, 99.9 % of the cells, is
  the bound such a tie would still meet);
* `python -m phyml_tpu_torch.evolve` (`-u tree` and `--coalescent N`)
  against phyml_tpu.evolve.main: the same alignment and true-tree
  files;
* the menu: the same key streams give the same namespace as
  phyml_tpu's `launch_interface(run=False)` apart from `platform`
  (the port's parser defaults to the card), the same screens; a
  no-argument `main` reading its standard input reaches the menu, and
  a menu run on a machine without a GPU stops at the card;
* `--ps` and `--alias_subpatt` through both CLIs (`-u tree -o lr`): the
  PostScript drawings' text apart from their coordinates, those within
  0.02 points (the fitted lengths agree to ~1e-6), and the same
  aliasing report.
"""

import io
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu import cli as jcli
from phyml_tpu import evolve as jevolve
from phyml_tpu import interface as jmenu
from phyml_tpu.io import draw as jdraw
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops import alias as jalias
from phyml_tpu.topology import Topology as JTopology
from phyml_tpu_torch import cli as tcli
from phyml_tpu_torch import evolve as tevolve
from phyml_tpu_torch import interface as tmenu
from phyml_tpu_torch.io import draw as tdraw
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops import alias as talias
from phyml_tpu_torch.topology import Topology as TTopology
from test_torch_bionj import _simulate

SIM_AGREE = 0.999
PS_TOL = 0.02


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_topos(n, seed, mean_blen=0.1):
    jt = JTopology.random(n, np.random.default_rng(seed), mean_blen=mean_blen)
    return jt, TTopology(jt.n_otu, jt.edges, jt.blen)


def test_alias_matches_phyml_tpu(tmp_path):
    names, seqs, topo = _simulate("nt", n_taxa=12, n_sites=200)
    rng = np.random.default_rng(4)
    # gaps and ambiguity codes, so tip codes go beyond single states
    seqs = ["".join(c if rng.random() > 0.05 else rng.choice(list("-NR"))
                    for c in s) for s in seqs]
    path = str(tmp_path / "gappy.phy")
    jevolve.write_phylip(path, names, seqs)
    jaln, taln = jread(path, datatype="nt"), tread(path, datatype="nt")
    child = np.asarray(topo.rooted().child)
    jc, tc = jalias.tip_pattern_codes(jaln), talias.tip_pattern_codes(taln)
    np.testing.assert_array_equal(tc, jc)
    ids = talias.subpattern_ids(tc, child)
    np.testing.assert_array_equal(ids, jalias.subpattern_ids(jc, child))
    for u in (0, 15, ids.shape[0] - 1):
        for a, b in zip(talias.alias_compaction(ids[u]),
                        jalias.alias_compaction(ids[u])):
            np.testing.assert_array_equal(a, b)
    jr, tr = jalias.alias_stats(jaln, child), talias.alias_stats(taln, child)
    np.testing.assert_array_equal(tr.unique_per_node, jr.unique_per_node)
    assert tr.redundancy == jr.redundancy > 1.0
    assert str(tr) == str(jr)


def test_drawing_matches_phyml_tpu(tmp_path):
    jt, tt = _both_topos(9, 2)
    names = [f"sp (x{i})" for i in range(9)]
    for a, b in zip(tdraw.tree_layout(tt, names)[:3],
                    jdraw.tree_layout(jt, names)[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tdraw.write_postscript(str(tmp_path / "t.ps"), tt, names, title="x")
    jdraw.write_postscript(str(tmp_path / "j.ps"), jt, names, title="x")
    assert (tmp_path / "t.ps").read_text() == (tmp_path / "j.ps").read_text()
    assert tdraw.ascii_tree(tt, names) == jdraw.ascii_tree(jt, names)


def _sim_models(dt):
    if dt == "nt":
        kw = dict(datatype="nt", name="GTR", n_classes=4, invar=True,
                  freqs_mode="fixed",
                  fixed_freqs=np.array([0.3, 0.2, 0.3, 0.2]))
        jm, tm = JModel(**kw), TModel(**kw)
        jp = jm.init_params()
        jp["rr_val"] = jnp.log(jnp.asarray([1.2, 3.0, 0.8, 1.1, 4.0, 1.0]))
        jp["pinv"] = jnp.asarray(0.2)
    else:
        kw = dict(datatype="aa", name="LG", n_classes=4, freqs_mode="model")
        jm, tm = JModel(**kw), TModel(**kw)
        jp = jm.init_params()
    jp["alpha"] = jnp.asarray(0.7)
    return jm, tm, jp


@pytest.mark.parametrize("dt", ["nt", "aa"])
def test_simulate_alignment_matches_phyml_tpu(dt):
    jm, tm, jp = _sim_models(dt)
    jt, tt = _both_topos(10, 6)
    jn, js = jevolve.simulate_alignment(jt, jm, jp, 300,
                                        np.random.default_rng(12))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    tn, ts = tevolve.simulate_alignment(tt, tm, tp, 300,
                                        np.random.default_rng(12))
    assert tn == jn
    a = np.array([list(s) for s in ts])
    b = np.array([list(s) for s in js])
    assert a.shape == b.shape == (10, 300)
    assert (a == b).mean() >= SIM_AGREE
    assert ts == js
    assert set("".join(ts)) <= set("ACGT" if dt == "nt" else
                                   "ARNDCQEGHILKMFPSTWYV")


@pytest.mark.parametrize("how", ["user_tree", "coalescent"])
def test_evolve_cli_matches_phyml_tpu(how, tmp_path):
    jt, _ = _both_topos(7, 3)
    names = [f"s{i}" for i in range(7)]
    tree = tmp_path / "tree.nwk"
    tree.write_text(jt.to_newick(names) + "\n")
    src = ["-u", str(tree)] if how == "user_tree" else \
        ["--coalescent", "6", "--theta", "0.3"]
    files = {}
    for tag, main in (("jax", jevolve.main), ("torch", tevolve.main)):
        out = str(tmp_path / tag)
        assert main([*src, "-m", "HKY85", "-l", "150", "-t", "3.0", "-a",
                     "0.6", "--r_seed", "17", "-o", out]) == 0
        files[tag] = (open(f"{out}.phy").read(),
                      open(f"{out}_true_tree.txt").read())
    assert files["torch"][1] == files["jax"][1]
    jl, tl = files["jax"][0].splitlines(), files["torch"][0].splitlines()
    assert tl[0] == jl[0]
    a = np.array([list(ln.split()[1]) for ln in tl[1:]])
    b = np.array([list(ln.split()[1]) for ln in jl[1:]])
    assert (a == b).mean() >= SIM_AGREE
    assert tl == jl


def _drive(mod, keys, run=False):
    out = io.StringIO()
    rc = mod.launch_interface(input_file="aln.phy", instream=iter(keys),
                              outstream=out, run=run)
    return rc, getattr(mod.launch_interface, "last_args", None), \
        out.getvalue()


KEYS = [
    ["Y"],
    ["+", "M", "M", "M", "C", "6", "A", "e", "Y"],
    ["D", "Y"],
    ["D", "D", "Y"],
    ["+", "+", "S", "R", "N", "3", "+", "B", "B", "B", "B", "B", "25", "y",
     "Y"],
    ["+", "+", "+", "B", "Y"],
    ["+", "F", "F", "V", "0.1", "T", "2.5", "R", "Y"],
    ["+", "+", "O", "L", "M", "U", "t.nwk", "Y"],
    ["I", "M", "2", "-", "-", "Y"],
    ["+", "C", "x", "Y"],
]


@pytest.mark.parametrize("keys", KEYS, ids=[str(i) for i in range(len(KEYS))])
def test_menu_matches_phyml_tpu(keys):
    rj, aj, sj = _drive(jmenu, keys)
    rt, at, st = _drive(tmenu, keys)
    assert rt == rj == 0
    assert st == sj
    vj, vt = vars(aj), vars(at)
    assert vt.pop("platform") == "gpu"
    vj.pop("platform")
    # the port's own profiler flag, which the menu leaves unset
    assert vt.pop("profile_out") is None
    assert vt == vj


def test_menu_quit_and_no_argument_main(monkeypatch, capsys):
    assert _drive(tmenu, ["Q"])[0] == 1
    # no arguments: main reads the file name and the keys from stdin
    monkeypatch.setattr(sys, "stdin", io.StringIO("aln.phy\n+\nQ\n"))
    assert tcli.main([]) == 1
    screen = capsys.readouterr().out
    assert "Enter the sequence file name" in screen
    assert "Menu : Input Data" in screen and "Menu : Substitution Model" \
        in screen


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal of a machine without a GPU")
def test_menu_run_takes_the_card(tmp_path, capsys):
    names, seqs, _ = _simulate("nt", n_taxa=5, n_sites=40)
    path = str(tmp_path / "tiny.phy")
    jevolve.write_phylip(path, names, seqs)
    rc = tmenu.launch_interface(input_file=path, instream=iter(["Y"]),
                                outstream=io.StringIO(), run=True)
    assert rc == 1
    assert "--platform gpu: no CUDA device" in capsys.readouterr().err


NUM = re.compile(r"-?\d+\.\d+")


def test_cli_ps_and_alias_match_phyml_tpu(tmp_path, capsys):
    names, seqs, topo = _simulate("nt", n_taxa=9, n_sites=150)
    out = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / tag
        d.mkdir()
        aln = str(d / "aln.phy")
        jevolve.write_phylip(aln, names, seqs)
        (d / "tree.nwk").write_text(topo.to_newick(names) + "\n")
        argv = ["-i", aln, "-u", str(d / "tree.nwk"), "-m", "HKY85", "-c",
                "4", "-o", "lr", "-b", "0", "--platform", "cpu",
                "--r_seed", "1", "--ps", "--alias_subpatt"]
        capsys.readouterr()
        assert main(argv) == 0
        alias = [ln for ln in capsys.readouterr().out.splitlines()
                 if "Subpattern aliasing" in ln]
        out[tag] = (open(f"{aln}_phyml_tree.ps").read().replace(
            str(d), "D"), alias)
    (jp, ja), (tp, ta) = out["jax"], out["torch"]
    assert len(ta) == 1 and ta == ja
    assert NUM.sub("#", tp) == NUM.sub("#", jp)
    np.testing.assert_allclose([float(x) for x in NUM.findall(tp)],
                               [float(x) for x in NUM.findall(jp)],
                               rtol=0, atol=PS_TOL)
