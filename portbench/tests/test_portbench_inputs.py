"""The frozen generator: one seed, one set of files; every seed, one
data set (the columns in another order)."""

import hashlib

import numpy as np
import pytest

from portbench import gen, harness
from portbench.reference import lnl as L

CONFIGS = ["nt120x10240-gtr-g4", "aa120x10240-lg-g4"]


def config(name):
    return harness.load_json(harness.HERE, "configs", name + ".json")


def digest(paths):
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_bytes(name, tmp_path):
    cfg = config(name)
    cfg["data"]["sites"] = 2048
    seed = 2 ** 31 + 12345
    a = gen.write_problem(cfg, seed, str(tmp_path / "a"))
    b = gen.write_problem(cfg, seed, str(tmp_path / "b"))
    c = gen.write_problem(cfg, seed + 1, str(tmp_path / "c"))
    assert digest(a) == digest(b)
    assert digest(a) != digest(c)
    # another seed: the same tree and the same columns in another order
    assert open(a[1]).read() == open(c[1]).read()
    da, dc = L.data_of(a[0], cfg), L.data_of(c[0], cfg)
    assert np.array_equal(da.weights.numpy(), dc.weights.numpy())
    assert np.array_equal(da.tips.numpy(), dc.tips.numpy())


@pytest.mark.parametrize("name", CONFIGS)
def test_pattern_counts(name, tmp_path):
    """The configurations at their own size; prints their patterns."""
    cfg = config(name)
    aln, tree = gen.write_problem(cfg, 7, str(tmp_path))
    data = L.data_of(aln, cfg)
    n, sites = cfg["data"]["taxa"], cfg["data"]["sites"]
    print(f"{name}: {n} taxa x {sites} sites, "
          f"{data.weights.numel()} patterns")
    assert len(data.names) == n and data.n_sites == sites
    assert 0.5 * sites < data.weights.numel() <= sites
    assert float(data.weights.sum()) == sites


def test_any_seed(tmp_path):
    cfg = config(CONFIGS[0])
    cfg["data"]["taxa"], cfg["data"]["sites"] = 6, 50
    for seed in (0, -1, 2 ** 64 + 3, 10 ** 30):
        gen.write_problem(cfg, seed, str(tmp_path / str(abs(seed))))
