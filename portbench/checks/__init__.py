"""The comparisons that decide `correct`, one kind a file:
`checks/<kind>.py`, found by the `check` of a traffic file.

A kind's file defines

* `judge(config, data, outputs, record, memo) -> (readings, verdicts)`:
  from
  what the window's units returned and what the unit's set-up handed
  over (`record`), the readings {number name: value} (the widest over
  the distinct outputs) and, for each distinct output, its own readings
  and the number of units that returned it;
* `control(config, data, outputs, record, memo) -> (outputs, record)`: the
  control's outputs in the program's place, the same in form: the
  reference computed with TF32 contractions at the same inputs.  They
  go through `judge` and the same limits as the program's.

A run is correct when every reading that has a limit
(`limits/<cell>.json`) lies at or under it (`verdict`).  The readings
are in log-likelihood units.  `memo` is a dict a run passes to both:
the reference's work at each point, worked out once.  What the kinds
share is here.
"""

from __future__ import annotations

import json
import math

import numpy as np

from portbench import registry
from portbench.reference import lnl as L
from portbench.reference import nni as N


def check_of(traffic):
    return registry.load("checks", traffic["check"])


def verdict(readings: dict, verdicts: list, limits: dict) -> dict:
    """{"correct", "failed" (units whose output breaks a limit),
    "compared" {name: {value, limit}}, "readings" (the rest)}."""
    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in readings.items() if k in limits}
    bad = sum(n for r, n in verdicts
              if any(not (v <= limits[k]) for k, v in r.items()
                     if k in limits))
    return {"correct": bool(bad == 0 and all(
                c["value"] <= c["limit"] for c in compared.values())),
            "failed": int(bad), "compared": compared,
            "readings": {k: v for k, v in readings.items()
                         if k not in limits}}


def widest(readings: dict, r: dict):
    for k, v in r.items():
        readings[k] = max(readings.get(k, -math.inf), v)


def distinct(records):
    """[(record, units)] of the distinct records, in order."""
    out = []
    for r in records:
        for o in out:
            if same(o[0], r):
                o[1].append(r)
                break
        else:
            out.append((r, [r]))
    return out


def same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def once(memo: dict, key, work):
    """work(), kept in memo under key: the reference's work at one point
    (a tree, its lengths, the model's values), which the control reads
    again at the program's points."""
    if key not in memo:
        memo[key] = work()
    return memo[key]


def point_key(config, fit):
    return (json.dumps(config["model"], sort_keys=True),
            fit["edges"].tobytes(), fit["blen"].tobytes(),
            json.dumps(fit["values"], sort_keys=True))


def at_point(config, data, fit, memo) -> dict:
    """{"lnl": the reference's lnL at the fit's point, "best": the
    highest its L-BFGS finds from there, "system": the model's eigen
    systems, "rt": the rooted tree}, worked out once a point."""
    def work():
        system = L.system(config, data, fit["values"])
        rt = L.root(fit["edges"], len(data.names))
        lnl = L.loglik(rt, *system, data, fit["blen"])
        _, best, _ = L.refine(config, data, fit["edges"], fit["blen"],
                              fit["values"])
        return {"lnl": lnl, "best": best, "system": system, "rt": rt}
    return once(memo, ("point",) + point_key(config, fit), work)


def fit_readings(config, data, fit, memo) -> dict:
    """`fit_gap`: the wider of (a) the gap between the lnL reported and
    the reference's lnL at the reported parameters and branch lengths,
    and (b) how far below the optimum that point lies: the highest lnL
    that the reference's L-BFGS finds from it, less the point's own."""
    p = at_point(config, data, fit, memo)
    below = max(p["best"], p["lnl"]) - p["lnl"]
    reported = abs(fit["lnl"] - p["lnl"])
    return {"fit_gap": max(reported, below),
            "fit_gap.reported": reported,
            "fit_gap.below_optimum": below}


def control_fit(config, data, fit, memo) -> dict:
    """The fit with its lnL the control's at the same point."""
    p = at_point(config, data, fit, memo)
    low = L.loglik(p["rt"], *p["system"], data, fit["blen"],
                   precision="tf32")
    return dict(fit, lnl=low)


def _log(x):
    """log of a support, floored at 1e-300: below it a support is
    rounding (aBayes of an arrangement that loses by > 690 lnL units)."""
    return math.log(max(x, 1e-300))


def nni_reading(ref_cand, ref_eid, ref_lnl, cand, lnl, supports):
    """(widest gap, of the lnL differences, of the log supports); the
    program's rows (v, u, a, b, s) have to be the reference's."""
    if not np.array_equal(np.asarray(ref_cand), np.asarray(cand)):
        raise ValueError("the program's internal edges and arrangements "
                         "are not the reference's")
    d_ref = ref_lnl[:, 1:] - ref_lnl[:, :1]
    d = lnl[:, 1:] - lnl[:, :1]
    diff = float(np.max(np.abs(d - d_ref))) if len(d) else 0.0
    sup = max((abs(_log(supports[int(e)]) - _log(float(s)))
               for e, s in zip(ref_eid, N.abayes(ref_lnl))), default=0.0)
    parts = [diff, sup]
    if any(math.isnan(x) for x in parts):
        return math.inf, diff, sup
    return max(parts), diff, sup
