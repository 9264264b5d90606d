"""Scalar maximization: bracketing + Brent parabolic/golden search.

A host-only copy of phyml_tpu/optim/brent.py.

Host-side driver used for model scalar parameters (kappa, alpha,
pinv, GTR rates, FreeRate rates/weights), mirroring the reference's
Generic_Brent_Lk (optimiz.c:2475) with the standard Brent method
(parabolic interpolation falling back to golden section).  Each
function evaluation is one likelihood call, so ~20 evals per
parameter is cheap; the expensive inner loops all stay on device.
"""

from __future__ import annotations

import math

_GOLD = 0.3819660112501051  # (3 - sqrt(5)) / 2


def bracket_maximum(f, a, b, max_expand: int = 30):
    """Expand (a, b) downhill in -f until a maximum is bracketed.
    Returns (a, m, b) with f(m) >= f(a), f(b)."""
    fa, fb = f(a), f(b)
    if fa > fb:
        a, b, fa, fb = b, a, fb, fa
    # now fb >= fa; expand past b
    c = b + 1.618 * (b - a)
    fc = f(c)
    n = 0
    while fc > fb and n < max_expand:
        a, b, fa, fb = b, c, fb, fc
        c = b + 1.618 * (b - a)
        fc = f(c)
        n += 1
    lo, hi = (a, c) if a < c else (c, a)
    return lo, b, hi


def brent_maximize(
    f,
    lo: float,
    hi: float,
    tol: float = 1e-4,
    max_iter: int = 60,
    x0: float | None = None,
):
    """Maximize f on [lo, hi]; returns (x_best, f_best).

    tol is the absolute x tolerance (the reference passes 1e-2..1e-4
    of the parameter scale into Generic_Brent_Lk).
    """
    a, b = float(lo), float(hi)
    x = float(x0) if x0 is not None else a + _GOLD * (b - a)
    x = min(max(x, a), b)
    w = v = x
    fw = fv = fx = f(x)
    d = e = 0.0
    for _ in range(max_iter):
        m = 0.5 * (a + b)
        tol1 = tol * (abs(x) + 1e-10)
        tol2 = 2.0 * tol1
        if abs(x - m) <= tol2 - 0.5 * (b - a):
            break
        p = q = r = 0.0
        if abs(e) > tol1:
            # parabolic fit through x, v, w (on -f, i.e. maximize)
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0.0:
                p = -p
            q = abs(q)
            e_prev, e = e, d
            if (abs(p) < abs(0.5 * q * e_prev) and p > q * (a - x)
                    and p < q * (b - x)):
                d = p / q
                u = x + d
                if (u - a) < tol2 or (b - u) < tol2:
                    d = tol1 if x < m else -tol1
            else:
                e = (b - x) if x < m else (a - x)
                d = _GOLD * e
        else:
            e = (b - x) if x < m else (a - x)
            d = _GOLD * e
        u = x + d if abs(d) >= tol1 else x + (tol1 if d > 0 else -tol1)
        fu = f(u)
        if fu >= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu >= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu >= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx
