"""LG under Galtier's covarion-like model (Galtier 2001, MBE 18:866), as
PhyML's M4 model builds it in its `--cov_alpha` mode (src/m4.c).

A site sits in one of K hidden rate classes and switches between them
along the tree at a constant rate; within class h it evolves under the
observed replacement process times the class's multiplier m_h.  States
are s = h * 20 + o (o an amino acid of ARNDCQEGHILKMFPSTWYV), so

    Q = blockdiag_h(m_h Q_o) + delta (S_h (x) I_20),  pi = h_fq (x) pi_o

with

* h_fq uniform (1 / K) and m_h the K rates of a mean-one discrete Gamma
  of shape cov_alpha;
* S_h the switches: h -> h' (h' != h) at h_fq[h'] / (1 - sum h_fq^2), so
  that a class is left at rate delta;
* Q_o the observed process: Q_o[i, j] = E[i, j] pi_o[j] (i != j), at
  mean rate one under pi_o;
* the whole scaled so that one OBSERVED substitution (a change of o) is
  expected a unit of branch length; switches do not count.

Free parameters x: (log cov_alpha, log cov_delta).  The reference's
other code scales a class to one expected event (`model.eigen`,
`lnl.q_matrices`), so `mixture` returns as the class's rate the ratio
of the unscaled Q's total event rate to its observed substitution rate
under pi: that turns one expected event into one expected observed
substitution.

Departures from the paper, each m4.c's:

* delta: Galtier's nu redraws the class among all K at each switch
  event, so a class is left at nu (K - 1) / K; here delta is that
  leaving rate (m4.c's switch normalisation).
* The Gamma classes: category means (Yang 1994), renormalised to mean
  one (`model.discrete_gamma`), PhyML's default discretisation.
* The observed exchangeabilities: m4.c seeds E from LG's Q at the
  frequencies pi_o, normalised to mean rate one, taking E[i, j] =
  q_LG[min(i, j), max(i, j)] floored at 1e-5 (the upper triangle
  mirrored), so Q_o[i, j] weighs LG's S[i, j] by pi_o[max(i, j)]
  pi_o[j], not by pi_o[j] alone as LG does.

The data are read in the model's states: `ALPHABET` gives each of the
80 states its observed letter (the generator writes hidden states as
those letters), the reader takes a letter into its last copy, and
`tips` folds the copies and spreads each observed letter over the K
hidden classes.  Frequencies, from the data's 80 states or LG's 20,
are folded to the 20 observed ones.
"""

import numpy as np
import torch

from portbench.reference import model as M

N_OBS = 20
ALPHABET = M.AA_STATES * 4
F64 = torch.float64
E_FLOOR = 1e-5          # m4.c's floor on the seeded exchangeabilities


def truth(model):
    x = np.log([float(model["cov_alpha"]), float(model["cov_delta"])])
    return x, M.lg()[1]


def start(values, model):
    """The program's `cov_alpha` and `cov_delta`."""
    return np.log([float(np.squeeze(values["cov_alpha"])),
                   float(np.squeeze(values["cov_delta"]))])


def values(x, model):
    return {"cov_alpha": float(np.exp(x[0])),
            "cov_delta": float(np.exp(x[1]))}


def observed(freqs):
    """[20] frequencies of the observed letters from those of 20 or 80
    states (the 80 folded over the hidden classes)."""
    f = freqs.reshape(-1, N_OBS).sum(0)
    return f / f.sum()


def tips(tips, model):
    """[n, P, 80] one-hot rows (a letter at its last copy) -> [n, P, K *
    20]: each observed letter is 1 in every hidden class."""
    obs = tips.reshape(*tips.shape[:-1], -1, N_OBS).sum(-2)
    return obs.repeat(1, 1, int(model["hidden"]))


def observed_exchangeabilities(pi_o):
    """[20, 20] E of m4.c: LG's Q at pi_o, mean rate one, its upper
    triangle floored and mirrored."""
    S = torch.as_tensor(M.lg()[0], dtype=F64, device=pi_o.device)
    q = S * pi_o[None, :]
    q = q / (pi_o * q.sum(-1)).sum()
    upper = torch.triu(torch.clamp(q, min=E_FLOOR), diagonal=1)
    return upper + upper.T


def generator(x, freqs, model):
    """(Q [80, 80] unscaled, pi [80]) at x; Q's diagonal is zero."""
    K = int(model["hidden"])
    dev = x.device
    pi_o = observed(freqs)
    E = observed_exchangeabilities(pi_o)
    q_o = E * pi_o[None, :]
    q_o = q_o / (pi_o * q_o.sum(-1)).sum()            # mean rate one
    h_fq = torch.full((K,), 1.0 / K, dtype=F64, device=dev)
    m = M.gamma_rates(x[0], K)
    delta = torch.exp(x[1])
    off = 1.0 - torch.eye(K, dtype=F64, device=dev)
    switch = off * h_fq[None, :] / (1.0 - (h_fq * h_fq).sum())
    eye_o = torch.eye(N_OBS, dtype=F64, device=dev)
    Q = torch.kron(torch.diag(m), q_o) + delta * torch.kron(switch, eye_o)
    pi = (h_fq[:, None] * pi_o[None, :]).reshape(-1)
    return Q, pi


def observed_rate(Q, pi):
    """(total event rate, observed substitution rate) of Q under pi."""
    n = Q.shape[-1]
    o = torch.arange(n, device=Q.device) % N_OBS
    flow = pi[:, None] * Q
    return flow.sum(), (flow * (o[:, None] != o[None, :])).sum()


def mixture(x, freqs, model):
    """One class: S [1, 80, 80] with Q = S pi off the diagonal, pi [1,
    80], its rate [1] (see the module's notes), weight [1]."""
    Q, pi = generator(x, freqs, model)
    S = Q / pi[None, :]
    S = (S + S.T) / 2.0                   # Q is reversible under pi
    total, obs = observed_rate(Q, pi)
    one = torch.ones(1, dtype=F64, device=x.device)
    return S[None], pi[None], (total / obs) * one, one
