"""`fit_gap` of the set-up fit the supports start from
(`checks.fit_readings`), and `nni_gap`: the widest, over every internal
edge, of the gap between the program's and the reference's lnL
differences of each NNI arrangement from the tree's own, and of the gap
between the logs of their aBayes supports (`reference/nni.py`)."""

from __future__ import annotations

from portbench import checks
from portbench.reference import nni as N


def reference_nni(config, data, fit, memo, precision="float64"):
    """(cand, eid, lnl [E, 3]) of the reference at the fit's point."""
    return checks.once(
        memo, ("nni", precision) + checks.point_key(config, fit),
        lambda: N.nni_lnl(config, data, fit["edges"], fit["blen"],
                          fit["values"], precision=precision))


def judge(config, data, outputs, record, memo):
    fit = record["fit"]
    readings = checks.fit_readings(config, data, fit, memo)
    cand, eid, ref = reference_nni(config, data, fit, memo)
    verdicts = []
    for rec, same in checks.distinct(outputs):
        gap, diff, sup = checks.nni_reading(cand, eid, ref, rec["cand"],
                                            rec["nni_lnl"], rec["supports"])
        checks.widest(readings, {"nni_gap": gap,
                                 "nni_gap.lnl_differences": diff,
                                 "nni_gap.log_supports": sup})
        verdicts.append(({"nni_gap": gap}, len(same)))
    return readings, verdicts


def control(config, data, outputs, record, memo):
    """The set-up fit's lnL the control's at its point; every unit's
    arrangements scored by the reference in TF32 from that point."""
    fit = record["fit"]
    cand, eid, low = reference_nni(config, data, fit, memo,
                                   precision="tf32")
    sup = dict(zip(eid.tolist(), N.abayes(low).tolist()))
    out = {"supports": sup, "cand": cand, "nni_lnl": low}
    return ([out for _ in outputs],
            {"fit": checks.control_fit(config, data, fit, memo)})
