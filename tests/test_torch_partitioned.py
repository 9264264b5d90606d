"""Partitioned analyses and the --xml front end against phyml_tpu, on
the CPU.

Two genes simulated by phyml_tpu down one topology (8 taxa; HKY85 with
400 sites, GTR with 300), each written to its own PHYLIP file (the
second with its rows in reverse order, so `reorder_taxa` runs), go
through both packages in float64:

* `joint_loglik` at a random tree, within 1e-6;
* one `nni_round_partitioned` and one `spr_round_partitioned` from a
  random start (one seed): the same trees (RF 0 for every partition's
  copy), the same moves applied, the combined lnL within 1e-6;
* `partitioned_search` (NNI): the same trees and combined lnL;
* `run_xml` with one <partitionelem> (an amino-acid mixture of four
  matrices read from PAML files written from LG4X's tables, FreeRate
  rates and weights, the NNI search) and with two (the XML of
  tests/test_partitioned.py, here with `search="spr"`): the same
  trees, the same combined lnL within 1e-6, and the same numbers in
  every stats file (`_part{k}` for two partitions) but the run time;
* a <phyrex> root with neither <coordinates> nor a <partitionelem>
  fails as phyml_tpu's does, naming no ROADMAP item (<phytime> and
  <phyrex> roots run: tests/test_torch_phytime.py,
  tests/test_torch_phyrex_xml.py).
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.evolve import simulate_alignment, write_phylip
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu.models import matrices as jmat
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.topology import Topology
from phyml_tpu_torch.interop import params_from_numpy
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from test_torch_mixture import write_paml

jpart = importlib.import_module("phyml_tpu.search.partitioned")
tpart = importlib.import_module("phyml_tpu_torch.search.partitioned")
jxml = importlib.import_module("phyml_tpu.io.xmlcfg")
txml = importlib.import_module("phyml_tpu_torch.io.xmlcfg")

LNL_TOL = 1e-6
N_TAXA = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As in tests/test_torch_bionj.py: one torch thread for the many
    small ops of the search."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genes(tmp_path, seed=5):
    """Two gene files simulated down one tree; returns their paths and
    the models' names."""
    rng = np.random.default_rng(seed)
    topo = Topology.random(N_TAXA, rng, mean_blen=0.12)
    names = [f"t{i}" for i in range(N_TAXA)]
    files = []
    for k, (name, n_sites) in enumerate((("HKY85", 400), ("GTR", 300))):
        model = JModel(datatype="nt", name=name, n_classes=1)
        params = model.init_params(np.full(4, 0.25))
        if name == "HKY85":
            params["kappa"] = 6.0
        _, seqs = simulate_alignment(topo, model, params, n_sites, rng)
        order = list(range(N_TAXA)) if k == 0 else \
            list(range(N_TAXA))[::-1]
        path = tmp_path / f"gene{k}.phy"
        write_phylip(str(path), [names[i] for i in order],
                     [seqs[i] for i in order])
        files.append(path)
    return files, ("HKY85", "GTR")


def _parts(tmp_path):
    """Both packages' Partition lists (float64 engines, starting
    parameters) on the two genes, taxa in the first file's order."""
    files, model_names = _genes(tmp_path)
    out = {"jax": [], "torch": []}
    names = None
    for path, name in zip(files, model_names):
        jaln, taln = jread(str(path), "nt"), tread(str(path), "nt")
        if names is None:
            names = list(jaln.names)
        jaln = jpart.reorder_taxa(jaln, names)
        taln = tpart.reorder_taxa(taln, names)
        np.testing.assert_array_equal(jaln.partials, taln.partials)
        jm = JModel(datatype="nt", name=name, n_classes=1)
        tm = TModel(datatype="nt", name=name, n_classes=1)
        jp = jm.init_params(jaln.obs_state_freqs)
        out["jax"].append(jpart.Partition(
            JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False), jm, jp))
        out["torch"].append(tpart.Partition(
            TEngine(taln, tm, dtype=torch.float64, device="cpu"), tm,
            params_from_numpy({k: np.asarray(v) for k, v in jp.items()})))
    return out


def _start(seed=11):
    return Topology.random(N_TAXA, np.random.default_rng(seed),
                           mean_blen=0.1)


def _same_trees(jt, tt):
    for a, b in zip(jt, tt):
        assert a.rf_distance(b) == 0
        np.testing.assert_allclose(a.blen, b.blen, atol=1e-5)


def test_joint_loglik_matches_phyml_tpu(tmp_path):
    parts = _parts(tmp_path)
    topo = _start()
    want = jpart.joint_loglik(parts["jax"], [topo, topo])
    got = tpart.joint_loglik(parts["torch"], [topo, topo])
    assert abs(got - want) < LNL_TOL, (got, want)


@pytest.mark.parametrize("kind", ["nni", "spr"])
def test_partitioned_round_matches_phyml_tpu(kind, tmp_path):
    parts = _parts(tmp_path)
    res = {}
    for tag in ("jax", "torch"):
        mod = jpart if tag == "jax" else tpart
        topos = [_start(), _start()]
        if kind == "nni":
            res[tag] = mod.nni_round_partitioned(parts[tag], topos)
        else:
            res[tag] = mod.spr_round_partitioned(
                parts[tag], topos, rng=np.random.default_rng(0))
    (jt, jl, jn), (tt, tl, tn) = res["jax"], res["torch"]
    assert tn == jn and tn > 0
    assert abs(tl - jl) < LNL_TOL, (tl, jl)
    _same_trees(jt, tt)


def test_partitioned_search_matches_phyml_tpu(tmp_path):
    parts = _parts(tmp_path)
    res = {tag: mod.partitioned_search(parts[tag], _start(), search="NNI",
                                       max_outer=4)
           for tag, mod in (("jax", jpart), ("torch", tpart))}
    (jt, jp, jl), (tt, tp, tl) = res["jax"], res["torch"]
    assert abs(tl - jl) < LNL_TOL, (tl, jl)
    _same_trees(jt, tt)
    assert tt[0].rf_distance(tt[1]) == 0
    for a, b in zip(jp, tp):
        for k, v in b.params.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(a.params[k]),
                                       atol=1e-4, err_msg=k)


TWO_PARTITIONS = """<phyml run.id="pp" output.file="joint">
  <topology><instance id="T1" init.tree="bionj" search="spr"
            optimise.tree="yes"/></topology>
  <ratematrices><instance id="M1" model="HKY85"/>
                <instance id="M2" model="GTR"/></ratematrices>
  <siterates><instance id="R1" init.value="1.0"/>
    <weights family="gamma" alpha="1.0"/></siterates>
  <equfreqs><instance id="F1" freqs="empirical"/></equfreqs>
  <branchlengths><instance id="L1" optimise.lens="yes"/>
                 <instance id="L2" optimise.lens="yes"/>
  </branchlengths>
  <partitionelem file.name="{f0}" data.type="nt" interleaved="no">
    <mixtureelem list="T1"/>
    <mixtureelem list="M1"/>
    <mixtureelem list="F1"/>
    <mixtureelem list="R1"/>
    <mixtureelem list="L1"/>
  </partitionelem>
  <partitionelem file.name="{f1}" data.type="nt" interleaved="no">
    <mixtureelem list="T1"/>
    <mixtureelem list="M2"/>
    <mixtureelem list="F1"/>
    <mixtureelem list="R1"/>
    <mixtureelem list="L2"/>
  </partitionelem>
</phyml>"""

# an LG4X-style mixture: four matrices from PAML files, free rates and
# weights (the reference's examples/lg4x layout)
MIXTURE = """<phyml run.id="mx" output.file="mix">
  <topology><instance id="T1" init.tree="bionj" search="nni"
            optimise.tree="yes"/></topology>
  <ratematrices>
    <instance id="M1" model="customaa" ratematrix.file="X1.mat"/>
    <instance id="M2" model="customaa" ratematrix.file="X2.mat"/>
    <instance id="M3" model="customaa" ratematrix.file="X3.mat"/>
    <instance id="M4" model="customaa" ratematrix.file="X4.mat"/>
  </ratematrices>
  <equfreqs><instance id="F1" freqs="model"/></equfreqs>
  <siterates>
    <instance id="R1" init.value="0.197063"/>
    <instance id="R2" init.value="0.750275"/>
    <instance id="R3" init.value="1.951569"/>
    <instance id="R4" init.value="0.420000"/>
    <weights family="freerates" optimise.freerates="yes">
      <instance appliesto="R1" value="0.287"/>
      <instance appliesto="R2" value="0.339"/>
      <instance appliesto="R3" value="0.195"/>
      <instance appliesto="R4" value="0.179"/>
    </weights>
  </siterates>
  <branchlengths><instance id="L1" optimise.lens="yes"/></branchlengths>
  <partitionelem file.name="prot.phy" data.type="aa" interleaved="no">
    <mixtureelem list="T1,T1,T1,T1"/>
    <mixtureelem list="M1,M2,M3,M4"/>
    <mixtureelem list="F1,F1,F1,F1"/>
    <mixtureelem list="R1,R2,R3,R4"/>
    <mixtureelem list="L1,L1,L1,L1"/>
  </partitionelem>
</phyml>"""


def _mixture_files(d):
    from phyml_tpu.models.substitution import lg4x_model

    rng = np.random.default_rng(21)
    topo = Topology.random(N_TAXA, rng, mean_blen=0.1)
    m = lg4x_model()
    p = m.init_params()
    p["class_rates_raw"] = jnp.log(jnp.asarray([0.2, 0.75, 1.95, 0.42]))
    names, seqs = simulate_alignment(topo, m, p, 120, rng)
    write_phylip(str(d / "prot.phy"), names, seqs)
    for i in range(1, 5):
        write_paml(str(d / f"X{i}.mat"), *jmat.empirical_aa(f"lg4x_{i}"))


def _stats_numbers(text):
    """Every number of a stats file but the header's version and the
    run time."""
    keep = [ln for ln in text.splitlines()
            if not ln.startswith(". Time used") and "---" not in ln]
    return [float(x) for x in re.findall(r"-?\d+\.\d+", "\n".join(keep))]


def _spy_lnl(monkeypatch, module):
    """The full-precision lnL each stats writer call gets."""
    seen = []
    real = module.format_stats

    def spy(**kw):
        seen.append(kw["lnl"])
        return real(**kw)

    monkeypatch.setattr(module, "format_stats", spy)
    return seen


@pytest.mark.parametrize("case", ["mixture", "two_partitions"])
def test_run_xml_matches_phyml_tpu(case, tmp_path, monkeypatch):
    import phyml_tpu.io.output as jout
    import phyml_tpu_torch.io.output as tout

    out = {}
    for tag, mod, omod in (("jax", jxml, jout), ("torch", txml, tout)):
        d = tmp_path / tag
        d.mkdir()
        if case == "mixture":
            _mixture_files(d)
            xml, stem, suffixes = MIXTURE, "mix", [""]
        else:
            files, _ = _genes(d)
            xml = TWO_PARTITIONS.format(f0=files[0].name, f1=files[1].name)
            stem, suffixes = "joint", ["_part1", "_part2"]
        (d / "run.xml").write_text(xml)
        seen = _spy_lnl(monkeypatch, omod)
        kw = {} if tag == "jax" else dict(device="cpu")
        assert mod.run_xml(str(d / "run.xml"), quiet=True, **kw) == 0
        names = jread(str(d / ("prot.phy" if case == "mixture"
                               else "gene0.phy")), "aa" if case == "mixture"
                      else "nt").names
        out[tag] = [(lnl, Topology.from_newick(
            (d / f"{stem}{s}_phyml_tree.txt").read_text(), names),
            (d / f"{stem}{s}_phyml_stats.txt").read_text())
            for lnl, s in zip(seen, suffixes)]
    for (jl, jt, js), (tl, tt, ts) in zip(out["jax"], out["torch"]):
        assert abs(tl - jl) < LNL_TOL, (tl, jl)
        assert tt.rf_distance(jt) == 0
        # the printed numbers: one unit in the last printed place apart
        # at most (a value within 1e-6 may round the other way)
        jn, tn = _stats_numbers(js), _stats_numbers(ts)
        assert len(jn) == len(tn)
        np.testing.assert_allclose(tn, jn, rtol=0, atol=1.01e-5)
        if case == "two_partitions":
            assert "Combined log-likelihood (all 2 partitions)" in ts
        else:
            assert "FreeRate mixture" in ts and "XMLMIX" in ts


@pytest.mark.parametrize("root, item", [
    ('<phyrex r.seed="1">', "'Bayesian tier'")])
def test_xml_features_left_unported_stop_the_run(root, item, tmp_path):
    """A <phyrex> root is ported: without <coordinates> or a
    <partitionelem> both packages' run_xml raise the same ValueError,
    and no message names the ROADMAP item that ported it."""
    tag = root[1:].split()[0].rstrip(">")
    (tmp_path / "run.xml").write_text(f"{root}</{tag}>")
    errs = []
    for mod, kw in ((jxml, {}), (txml, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            mod.run_xml(str(tmp_path / "run.xml"), **kw)
        errs.append(str(exc.value))
    assert errs[0] == errs[1] and "no <partitionelem> found" in errs[1]
    assert item not in errs[1] and "ROADMAP" not in errs[1]
