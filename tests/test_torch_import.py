"""phyml_tpu_torch stands alone: no JAX and no phyml_tpu.

The machine with the GPU has no JAX, so importing every module of the
port must pull in neither.  The check runs in a subprocess because
this test process already imported jax (tests/conftest.py).  The
modules of the auxiliary tools, of PhyREX and of --distributed are
among those checked.
"""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "phyml_tpu_torch"


def _sources():
    # build/ holds compiled kernels, not package modules
    return [p for p in sorted(PKG.rglob("*.py"))
            if "build" not in p.relative_to(PKG).parts]


def _modules():
    for path in _sources():
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_import_pulls_in_no_jax():
    mods = list(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'phyml_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", res.stdout
    assert len(mods) >= 20
    # the search and support modules are among them
    assert {f"phyml_tpu_torch.search.{m}" for m in
            ("distances", "bionj", "nni", "spr", "driver", "support",
             "stepwise", "constraint")} <= set(mods)
    # and so are the auxiliary tools
    assert {f"phyml_tpu_torch.{m}" for m in
            ("ops.ancestral", "ops.crossval", "ops.alias", "optim.fastlk",
             "optim.brent", "io.draw", "evolve", "interface")} <= set(mods)
    # and PhyREX's
    assert {f"phyml_tpu_torch.bayes.{m}" for m in
            ("traits", "geo", "phyrex", "slfv")} <= set(mods)
    # and --distributed's
    assert {f"phyml_tpu_torch.parallel{m}" for m in
            ("", ".mesh", ".boot")} <= set(mods)


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import phyml_tpu\b(?!_)"
                     r"|from phyml_tpu\b(?!_))", re.M)
    hits = [str(p) for p in _sources() if pat.search(p.read_text())]
    assert hits == []
