"""The units of work a traffic mix repeats, one kind a file:
`units/<kind>.py`, found by the `unit` of a traffic file
(`traffic/<mix>.json`).

A kind's file defines `Unit(traffic, config, aln, tree, platform,
r_seed)`; the harness calls `setup()` once, then `run()` once for the
warm-up and once for every unit of the window, then `free()`.  Each
`run()` returns what the comparison (`checks/<kind>.py`) judges, and
the unit's `record` what its set-up hands to it: plain dicts of numbers
and arrays, no object of the program.  What the kinds share is here.
"""

from __future__ import annotations

import contextlib

import numpy as np

from portbench import registry


def unit_of(traffic, config, aln, tree, platform, r_seed):
    return registry.load("units", traffic["unit"]).Unit(
        traffic, config, aln, tree, platform, r_seed)


def fill(template, aln, tree, config, platform, r_seed):
    """A traffic file's argv with {aln}, {tree}, {model} (the
    configuration's PhyML options), {platform} and {r_seed} filled in."""
    out = []
    for word in template:
        if word == "{model}":
            out += list(config["phyml_args"])
        else:
            out.append(word.format(aln=aln, tree=tree, platform=platform,
                                   r_seed=r_seed))
    return out


@contextlib.contextmanager
def patched(obj, name, wrapper_of):
    """obj.name replaced by wrapper_of(original) inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrapper_of(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def values_of(params) -> dict:
    """The program's fitted parameter dict as float64 lists (a scalar as
    a float), read by the reference's model (`start`)."""
    out = {}
    for k, v in params.items():
        if hasattr(v, "detach"):
            out[k] = np.asarray(v.detach().cpu(), dtype=np.float64).tolist()
    return out


def fit_record(lnl, params, topo) -> dict:
    return {"lnl": float(lnl), "values": values_of(params),
            "edges": np.asarray(topo.edges, dtype=np.int64).copy(),
            "blen": np.asarray(topo.blen, dtype=np.float64).copy()}
