"""MCMC diagnostics: effective sample size (reference: the ESS
tracking of mcmc.c:146 MCMC_Update_Effective_Sample_Size, reported in
the phytime trace summaries)."""

from __future__ import annotations

import numpy as np


def effective_sample_size(x: np.ndarray) -> float:
    """ESS via the initial-monotone-positive-sequence estimator
    (Geyer 1992): tau = -1 + 2 * sum_k Gamma_k over the initial
    monotone positive pair sums Gamma_k = rho_{2k} + rho_{2k+1}.
    x: 1-D chain of a scalar statistic (post burn-in)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if n < 4:
        return float(n)
    x = x - x.mean()
    if not np.any(x):
        return float(n)
    # autocorrelations via FFT
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acov = np.fft.irfft(f * np.conj(f), m)[:n].real / n
    rho = acov / acov[0]

    tau = -1.0
    run = np.inf
    for k in range(0, (n - 1) // 2):
        g = rho[2 * k] + rho[2 * k + 1]
        if g <= 0:
            break
        g = min(g, run)      # enforce monotone decrease
        run = g
        tau += 2.0 * g
    tau = max(tau, 1.0 / n)
    return float(min(n, n / tau))


def ess_report(trace: np.ndarray, burnin_rows: int = 0,
               names=("posterior", "lnL", "root_height",
                      "log_clock", "log_nu")) -> dict[str, float]:
    """ESS for each traced column of the MCMC trace [T, k]."""
    t = np.asarray(trace)[burnin_rows:]
    return {nm: effective_sample_size(t[:, i])
            for i, nm in enumerate(names[:t.shape[1]])}
