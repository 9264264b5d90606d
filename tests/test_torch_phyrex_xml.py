"""The <phyrex> XML root through both packages' run_xml, on the CPU.

An XML written in tmp_path: the 6-taxon alignment of
tests/test_torch_bayes.py, its simulating tree as the user tree,
HKY85+G4, tip coordinates simulated as Brownian motion down the tree
(tests/test_torch_phyrex.py) in a coordinates file, 300 iterations
(mcmc_iter_cap).  Three cases: <spatialmodel name="rrw+lognormal"> with
a lognormal clock and topology moves, "ibm" at a fixed topology, and
no <spatialmodel> (SLFV, the default).  Both packages write the same
trace header, row count and comment lines, the same stats labels and
a chronogram of every taxon; read_coordinates gives equal arrays from
exact-name rows and from '|Name|' rows matched inside the taxon labels.
A <phyrex> root without <coordinates> fails in both packages alike.
"""

import numpy as np
import pytest
import torch

from phyml_tpu.io import xmlcfg as jxml
from phyml_tpu_torch.io import xmlcfg as txml
from test_torch_bayes import _problem
from test_torch_phyrex import _coords

XML_ITERS = 300


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def phyrex_xml(d, aln_name, tree_path, coord_name, spatial=None,
               lineagerates="lognormal", sample_topology=True, seed=3):
    """A <phyrex> analysis: HKY85+G4 on aln_name, the user tree, the
    coordinates file, the <spatialmodel> (SLFV, the default, when
    None)."""
    sm = f'  <spatialmodel name="{spatial}"/>\n' if spatial else ""
    lr = (f'  <lineagerates model="{lineagerates}"/>\n'
          if lineagerates else "")
    opt = "yes" if sample_topology else "no"
    text = f"""<phyrex run.id="geo" output.file="out" r.seed="{seed}"
  mcmc.chain.len="1e5" mcmc.sample.every="10" mcmc.burnin="100">
{sm}{lr}  <topology><instance id="T1" init.tree="user" file.name="{tree_path}"
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
  <coordinates file.name="{coord_name}"/>
</phyrex>
"""
    path = d / "phyrex.xml"
    path.write_text(text)
    return str(path)


def write_coordinates(path, names, x, bars=False):
    """The reference's coordinates format: a '# state.name lon lat'
    header, then one 'Name lon lat' row a taxon ('|Name| lon lat' with
    bars, matched as a token inside the taxon labels)."""
    with open(path, "w") as fh:
        fh.write("# state.name lon lat\n")
        for nm, (a, b) in zip(names, x):
            row = f"|{nm}|" if bars else nm
            fh.write(f"{row} {float(a)!r} {float(b)!r}\n")


def _labels(stats):
    return [ln.split(":")[0] if ":" in ln else ln.split()[0]
            for ln in stats.splitlines()]


@pytest.mark.parametrize("spatial, sample_topology", [
    ("rrw+lognormal", True), ("ibm", False), (None, True)],
    ids=["rrw", "ibm", "slfv"])
def test_phyrex_xml_matches_phyml_tpu(tmp_path, spatial, sample_topology):
    jtt, _, _ = _problem(tmp_path)
    (tmp_path / "tree.nwk").write_text(jtt.to_newick())
    x = _coords(jtt, s2=2.0)
    out = {}
    for pkg, mod in (("phyml_tpu", jxml), ("phyml_tpu_torch", txml)):
        d = tmp_path / pkg
        d.mkdir()
        (d / "aln.phy").write_text((tmp_path / "aln7.phy").read_text())
        write_coordinates(d / "coords.txt", jtt.names, x)
        xml = phyrex_xml(d, "aln.phy", str(tmp_path / "tree.nwk"),
                         "coords.txt", spatial,
                         sample_topology=sample_topology)
        kw = {"device": "cpu"} if pkg == "phyml_tpu_torch" else {}
        assert mod.run_xml(xml, quiet=True, mcmc_iter_cap=XML_ITERS,
                           **kw) == 0
        out[pkg] = [(d / f"out_geo{s}").read_text() for s in (
            "_phyml_trace.txt", "_phyml_stats.txt", "_chronogram.txt")]
        labels = [f"A|{nm}|2020" for nm in jtt.names]
        write_coordinates(d / "bars.txt", jtt.names, x, bars=True)
        for f, nms in (("coords.txt", jtt.names), ("bars.txt", labels)):
            got = txml.read_coordinates(str(d / f), list(nms))
            np.testing.assert_array_equal(
                got, jxml.read_coordinates(str(d / f), list(nms)))
            np.testing.assert_array_equal(got, x)
    (jtrace, jstats, jchron), (ttrace, tstats, tchron) = \
        out["phyml_tpu"], out["phyml_tpu_torch"]
    jrows, trows = jtrace.splitlines(), ttrace.splitlines()
    assert trows[0] == jrows[0]
    assert len(trows) == len(jrows)
    assert [r.split("=")[0] for r in trows if r.startswith("#")] == \
        [r.split("=")[0] for r in jrows if r.startswith("#")]
    assert all(np.isfinite([float(v) for v in r.split("\t")]).all()
               for r in trows[1:] if not r.startswith("#"))
    assert _labels(tstats) == _labels(jstats)
    assert "PhyREX" in tstats
    assert tchron.strip().endswith(";") and \
        all(nm in tchron for nm in jtt.names)
    assert tchron.count("(") == jchron.count("(") == jtt.n_otu - 1


def test_phyrex_root_without_coordinates_fails_as_phyml_tpu(tmp_path):
    """A <phyrex> root with a partition but no <coordinates> fails in
    read_coordinates in both packages (no file to read)."""
    jtt, _, _ = _problem(tmp_path)
    (tmp_path / "tree.nwk").write_text(jtt.to_newick())
    xml = phyrex_xml(tmp_path, "aln7.phy", str(tmp_path / "tree.nwk"), "x")
    text = (tmp_path / "phyrex.xml").read_text()
    (tmp_path / "phyrex.xml").write_text(
        text.replace('  <coordinates file.name="x"/>\n', ""))
    errs = []
    for mod, kw in ((jxml, {}), (txml, {"device": "cpu"})):
        with pytest.raises(TypeError) as exc:
            mod.run_xml(xml, quiet=True, mcmc_iter_cap=10, **kw)
        errs.append(str(exc.value))
    assert errs[0] == errs[1]
