"""`fit_gap` of every distinct fit the window returned
(`checks.fit_readings`)."""

from __future__ import annotations

from portbench import checks


def judge(config, data, outputs, record, memo):
    readings, verdicts = {}, []
    for rec, same in checks.distinct(outputs):
        r = checks.fit_readings(config, data, rec["fit"], memo)
        checks.widest(readings, r)
        verdicts.append((r, len(same)))
    return readings, verdicts


def control(config, data, outputs, record, memo):
    """Each fit's lnL the control's at the program's fitted point."""
    return ([{"fit": checks.control_fit(config, data, o["fit"], memo)}
             for o in outputs], record)
