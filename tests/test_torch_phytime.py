"""The <phytime> XML root through both packages' run_xml, on the CPU.

An XML written in tmp_path (the reference's dating example is absent):
the 6-taxon alignment of tests/test_torch_bayes.py, its simulating tree
as the user tree, HKY85+G4, a root calibration and a clade
calibration, 300 iterations (mcmc_iter_cap).  Two cases: a lognormal
clock with topology moves (`<lineagerates model="lognormal">`,
optimise.tree="yes") and the Guindon 2012 clock (no <lineagerates>,
the XML default) at a fixed topology.  Both packages:

* start from the same chronogram: the user tree's branch lengths
  fitted, then TimeTree.from_topology.  phyml_tpu fits them with a
  float32 engine, the port with a float64 one on the CPU, so the
  heights agree within START_REL (float32 Newton);
* write the trace, stats and chronogram files in phyml_tpu's format:
  the same trace header, rows and comment lines, the same stats
  labels, a chronogram of all taxa.

With mutmap="yes" on the root (the lognormal case at 100 iterations),
both packages write a mutation map of the final tree in one format,
and the port's events are consistent: each within its edge's length,
each (edge, site)'s events chained state to state.  The <phyrex> root
runs too (tests/test_torch_phyrex_xml.py).
"""

import importlib

import numpy as np
import pytest
import torch

from phyml_tpu.io import xmlcfg as jxml
from phyml_tpu_torch import cli as tcli
from phyml_tpu_torch.io import xmlcfg as txml
from test_torch_bayes import _problem

START_REL = 1e-4
ITERS = 300


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dating_xml(d, aln_name, tree_path, names, root_h, clade, clade_h,
               lineagerates=None, sample_topology=True, seed=3,
               mutmap=False):
    """A <phytime> analysis: HKY85+G4 on aln_name, the user tree, a root
    calibration around root_h and one on `clade` around clade_h."""
    lr = (f'  <lineagerates model="{lineagerates}"/>\n'
          if lineagerates else "")
    taxa = "".join(f'<taxon value="{t}"/>' for t in names)
    sub = "".join(f'<taxon value="{t}"/>' for t in clade)
    opt = "yes" if sample_topology else "no"
    mm = ' mutmap="yes"' if mutmap else ""
    text = f"""<phytime run.id="dating" output.file="out" r.seed="{seed}"{mm}
  mcmc.chain.len="1e5" mcmc.sample.every="10" mcmc.burnin="100">
{lr}  <topology><instance id="T1" init.tree="user" file.name="{tree_path}"
    optimise.tree="{opt}"/></topology>
  <ratematrices><instance id="M1" model="HKY85"/></ratematrices>
  <siterates>
    <instance id="R1" init.value="1.0"/><instance id="R2" init.value="1.0"/>
    <instance id="R3" init.value="1.0"/><instance id="R4" init.value="1.0"/>
    <weights family="gamma" alpha="0.8"/>
  </siterates>
  <equfreqs><instance id="F1" freqs="empirical"/></equfreqs>
  <branchlengths><instance id="B1"/></branchlengths>
  <partitionelem file.name="{aln_name}" data.type="nt" interleaved="no">
    <mixtureelem list="T1,T1,T1,T1"/>
    <mixtureelem list="M1,M1,M1,M1"/>
    <mixtureelem list="F1,F1,F1,F1"/>
    <mixtureelem list="R1,R2,R3,R4"/>
    <mixtureelem list="B1,B1,B1,B1"/>
  </partitionelem>
  <clade id="all">{taxa}</clade>
  <clade id="c1">{sub}</clade>
  <calibration clade.id="all"><lower>{0.5 * root_h}</lower>
    <upper>{3.0 * root_h}</upper></calibration>
  <calibration clade.id="c1"><lower>{0.2 * clade_h}</lower>
    <upper>{4.0 * clade_h}</upper></calibration>
</phytime>
"""
    path = d / "dating.xml"
    path.write_text(text)
    return str(path)


def _run(pkg, xml, monkeypatch, **kw):
    """run_xml of one package with its run_phytime wrapped to keep the
    start chronogram; returns (start TimeTree, trace, stats,
    chronogram)."""
    date = importlib.import_module(f"{pkg}.bayes.date")
    seen = []
    real = date.run_phytime
    monkeypatch.setattr(date, "run_phytime",
                        lambda aln, tt, **a: seen.append(tt) or
                        real(aln, tt, **a))
    mod = jxml if pkg == "phyml_tpu" else txml
    assert mod.run_xml(xml, quiet=True, mcmc_iter_cap=ITERS, **kw) == 0
    d = xml.rsplit("/", 1)[0]
    out = [seen[0]]
    for suffix in ("_phyml_trace.txt", "_phyml_stats.txt",
                   "_chronogram.txt"):
        with open(f"{d}/out_dating{suffix}") as fh:
            out.append(fh.read())
    return out


def _labels(stats):
    return [ln.split(":")[0] for ln in stats.splitlines()]


@pytest.mark.parametrize("lineagerates, sample_topology", [
    ("lognormal", True), (None, False)])
def test_phytime_xml_matches_phyml_tpu(tmp_path, monkeypatch, lineagerates,
                                       sample_topology):
    jtt, _, _ = _problem(tmp_path)
    tree_path = tmp_path / "tree.nwk"
    tree_path.write_text(jtt.to_newick())
    h = np.asarray(jtt.heights)
    c0, c1 = (int(x) for x in jtt.child[0])
    clade = [jtt.names[c] for c in (c0, c1) if c < jtt.n_otu] or \
        list(jtt.names[:2])
    runs = {}
    for pkg in ("phyml_tpu", "phyml_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "aln.phy").write_text((tmp_path / "aln7.phy").read_text())
        xml = dating_xml(d, "aln.phy", str(tree_path), list(jtt.names),
                         h[jtt.root], clade, h[jtt.n_otu], lineagerates,
                         sample_topology)
        kw = {"device": "cpu"} if pkg == "phyml_tpu_torch" else {}
        runs[pkg] = _run(pkg, xml, monkeypatch, **kw)
    (jt, jtrace, jstats, jchron), (tt, ttrace, tstats, tchron) = \
        runs["phyml_tpu"], runs["phyml_tpu_torch"]
    np.testing.assert_array_equal(tt.child, jt.child)
    np.testing.assert_allclose(tt.heights, jt.heights, rtol=START_REL,
                               atol=1e-12)
    jrows, trows = jtrace.splitlines(), ttrace.splitlines()
    assert trows[0] == jrows[0] == \
        "iter\tposterior\tlnL\troot_height\tclock\tnu"
    assert len(trows) == len(jrows) == 1 + ITERS // 10 + (
        2 if sample_topology else 1)
    assert [r.split("\t")[0] for r in trows[:-2]] == \
        [r.split("\t")[0] for r in jrows[:-2]]
    assert [r.split("=")[0] for r in trows if r.startswith("#")] == \
        [r.split("=")[0] for r in jrows if r.startswith("#")]
    assert all(np.isfinite([float(x) for x in r.split("\t")]).all()
               for r in trows[1:] if not r.startswith("#"))
    assert _labels(tstats) == _labels(jstats)
    assert "chronogram" in tstats
    assert tchron.strip().endswith(";") and \
        all(nm in tchron for nm in jtt.names)
    assert tchron.count("(") == jchron.count("(") == jtt.n_otu - 1


def test_cli_runs_a_phytime_xml_on_the_cpu(tmp_path):
    """python -m phyml_tpu_torch.cli --xml dating.xml --platform cpu."""
    jtt, _, _ = _problem(tmp_path)
    tree_path = tmp_path / "tree.nwk"
    tree_path.write_text(jtt.to_newick())
    h = np.asarray(jtt.heights)
    xml = dating_xml(tmp_path, "aln7.phy", str(tree_path), list(jtt.names),
                     h[jtt.root], list(jtt.names), h[jtt.root],
                     "strict", False)
    text = (tmp_path / "dating.xml").read_text().replace(
        'mcmc.chain.len="1e5"', 'mcmc.chain.len="200"')
    (tmp_path / "dating.xml").write_text(text)
    assert tcli.main(["--xml", xml, "--platform", "cpu", "--quiet"]) == 0
    for suffix in ("_phyml_trace.txt", "_phyml_stats.txt",
                   "_chronogram.txt"):
        assert (tmp_path / f"out_dating{suffix}").stat().st_size > 0


def test_phytime_xml_writes_a_mutation_map(tmp_path):
    jtt, _, _ = _problem(tmp_path)
    tree_path = tmp_path / "tree.nwk"
    tree_path.write_text(jtt.to_newick())
    h = np.asarray(jtt.heights)
    maps = {}
    for pkg, mod, kw in (("phyml_tpu", jxml, {}),
                         ("phyml_tpu_torch", txml, {"device": "cpu"})):
        d = tmp_path / pkg
        d.mkdir()
        (d / "aln.phy").write_text((tmp_path / "aln7.phy").read_text())
        xml = dating_xml(d, "aln.phy", str(tree_path), list(jtt.names),
                         h[jtt.root], list(jtt.names[:2]), h[jtt.n_otu],
                         "lognormal", False, mutmap=True)
        assert mod.run_xml(xml, quiet=True, mcmc_iter_cap=100, **kw) == 0
        maps[pkg] = (d / "out_dating_phyml_mutmap.txt").read_text() \
            .splitlines()
        chrono = (d / "out_dating_chronogram.txt").read_text()
    for lines in maps.values():
        assert lines[0] == ("# sampled substitution history "
                            "(node, site, time_from_parent, from, to)")
        assert len(lines) > 1
    # the port's events on its final chronogram's edges
    by = {}
    for ln in maps["phyml_tpu_torch"][1:]:
        u, p, t, a, b = ln.split("\t")
        assert 0 <= int(u) < 2 * jtt.n_otu - 2 and float(t) > 0
        assert 0 <= int(a) < 4 and 0 <= int(b) < 4 and a != b
        by.setdefault((int(u), int(p)), []).append((float(t), int(a),
                                                    int(b)))
    for evs in by.values():
        evs.sort()
        for (_, _, b), (_, a, _) in zip(evs, evs[1:]):
            assert a == b
    assert chrono.strip().endswith(";")
