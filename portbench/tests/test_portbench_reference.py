"""The plain reference against brute-force sums over ancestral states
on four taxa, and the rule on imports: nothing under portbench/ imports
JAX or the JAX package, and the reference nothing of the program."""

import ast
import itertools
import os

import numpy as np
import pytest
import torch

from portbench.reference import lnl as L
from portbench.reference import model as M
from portbench.reference import nni as N

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {"model": {"name": "GTR", "categories": 4,
                    "fit_frequencies": "empirical"}}
RATES = [1.2, 3.0, 0.8, 1.1, 4.0, 1.0]
# as the program reports them: log exchangeabilities, the Gamma shape
VALUES = {"rr_val": np.log(RATES).tolist(), "alpha": 0.7}


def pmats(lam, V, Vinv, t):
    """[C, ns, ns]: each class's P(t) from its own eigen system."""
    return np.stack([M.pmat(lam[c], V[c], Vinv[c], t)
                     for c in range(len(lam))])


def write_aln(path, rows):
    with open(path, "w") as fh:
        fh.write(f" {len(rows)} {len(rows[0])}\n")
        for i, r in enumerate(rows):
            fh.write(f"T{i:04d}      {r}\n")


@pytest.fixture
def four(tmp_path):
    rng = np.random.default_rng(3)
    rows = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(4)]
    rows[1] = rows[0][:30] + rows[1][30:]
    path = str(tmp_path / "a.phy")
    write_aln(path, rows)
    return L.load_data(path, "ACGT"), rows


def brute_site(P_edges, topo, pi, w, cols):
    """Per column: sum over the two ancestral states of a four-taxon
    tree ((x1, x2) v, (x3, x0) u) with edges (x1, x2, x3, x0, central),
    each P [C, 4, 4], over the classes of weights w [C] and frequencies
    pi [C, 4]."""
    x1, x2, x3, x0 = topo
    out = []
    for col in cols:
        tot = 0.0
        for c in range(len(w)):
            P = [pm[c] for pm in P_edges]
            for su, sv in itertools.product(range(4), repeat=2):
                tot += (pi[c][su] * P[3][su, col[x0]] * P[2][su, col[x3]]
                        * P[4][su, sv] * P[0][sv, col[x1]]
                        * P[1][sv, col[x2]]) * w[c]
        out.append(np.log(tot))
    return np.asarray(out)


def test_pruning_against_brute_force(four):
    data, rows = four
    # tips 0,1 on node 4; tips 2,3 on node 5
    edges = np.array([[4, 0], [4, 1], [5, 2], [5, 3], [4, 5]])
    blen = np.array([0.05, 0.11, 0.21, 0.07, 0.13])
    lam, V, Vinv, w, pi = L.system(CONFIG, data, VALUES)
    rt = L.root(edges, 4)
    got = L.loglik(rt, lam, V, Vinv, w, pi, data, blen)
    cols = [[ "ACGT".index(r[j]) for r in rows] for j in range(len(rows[0]))]
    P = [pmats(lam, V, Vinv, t) for t in blen]
    # edge order (x1, x2, x3, x0, central) = (2, 3, 1, 0, 4)
    want = brute_site([P[2], P[3], P[1], P[0], P[4]], (2, 3, 1, 0), pi,
                      w, cols).sum()
    assert got == pytest.approx(want, abs=1e-9)
    low = L.loglik(rt, lam, V, Vinv, w, pi, data, blen, "tf32")
    assert abs(low - want) > 1e-7          # the control is not float64


def test_nni_against_brute_force(four):
    data, rows = four
    edges = np.array([[4, 0], [4, 1], [5, 2], [5, 3], [4, 5]])
    blen = np.array([0.05, 0.11, 0.21, 0.07, 0.13])
    lens = []
    cand, eid, lnl = N.nni_lnl(CONFIG, data, edges, blen, VALUES,
                               lengths=lens)
    assert cand.shape == (1, 5) and eid.tolist() == [4]
    v, u, a, b, s = cand[0]
    assert (v, u) == (4, 5) and {a, b} == {2, 3} and s == 1
    t1, t2, t3, tc = (x[0] for x in lens[0])
    lam, V, Vinv, w, pi = L.system(CONFIG, data, VALUES)
    cols = [["ACGT".index(r[j]) for r in rows] for j in range(len(rows[0]))]
    roles = [(a, b, s), (a, s, b), (b, s, a)]
    P = lambda t: pmats(lam, V, Vinv, t)
    for k, (x1, x2, x3) in enumerate(roles):
        want = brute_site([P(t1[k]), P(t2[k]), P(t3[k]), P(blen[0]),
                           P(tc[k])], (x1, x2, x3, 0), pi, w,
                          cols).sum()
        assert lnl[0, k] == pytest.approx(want, abs=1e-8)
    # the tree's own arrangement improves on its given lengths
    rt = L.root(edges, 4)
    assert lnl[0, 0] >= L.loglik(rt, lam, V, Vinv, w, pi, data,
                                 blen) - 1e-9
    sup = N.abayes(lnl)
    assert 0.0 <= sup[0] <= 1.0


def imports_of(path):
    """Top-level names a file imports, static and through
    importlib.import_module with a literal."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {p: imports_of(p) & {"jax", "jaxlib", "flax", "phyml_tpu"}
             for p in sources(HERE)}
    assert not {p: n for p, n in found.items() if n}
    # the port's name begins with the JAX package's and is another name
    assert "phyml_tpu_torch" in set().union(*(imports_of(p)
                                              for p in sources(HERE)))


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    used = set().union(*(imports_of(p) for p in sources(ref)))
    assert "phyml_tpu_torch" not in used and "phyml_tpu" not in used
    assert used <= {"__future__", "math", "json", "os", "dataclasses",
                    "numpy", "scipy", "torch", "portbench"}
