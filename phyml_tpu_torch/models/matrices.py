"""Empirical amino-acid replacement matrices.

The numeric tables are the published constants of the respective
models (Le & Gascuel 2008 LG; Whelan & Goldman 2001 WAG; Jones,
Taylor & Thornton 1992 JTT; etc.), stored as data in
phyml_tpu_torch/data/aa_matrices.npz: for each model a symmetric 20x20
exchangeability matrix `<name>_s` and stationary frequencies
`<name>_pi` in PhyML's amino-acid order ARNDCQEGHILKMFPSTWYV
(reference: the Init_Qmat_* tables, init.c:1580-5000).

Custom matrices are read from PAML-format .dat files (lower-triangular
exchangeabilities + frequencies), the same format the reference's
CUSTOMAA model consumes (`--aa_rate_file`, examples/lg4x/X*.mat).
"""

from __future__ import annotations

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "..", "data",
                     "aa_matrices.npz")

AA_MODELS = (
    "lg", "wag", "jtt", "dayhoff", "dcmut", "mtrev", "rtrev", "cprev",
    "vt", "blosum62", "mtmam", "mtart", "hivw", "hivb", "flu", "ab",
)

_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}


def empirical_aa(name: str) -> tuple[np.ndarray, np.ndarray]:
    """Return (S [20,20] symmetric exchangeabilities, pi [20])."""
    key = name.lower()
    if key not in _cache:
        with np.load(_DATA) as z:
            if f"{key}_s" not in z:
                raise ValueError(
                    f"unknown empirical AA model {name!r}; "
                    f"available: {sorted(AA_MODELS)}"
                )
            _cache[key] = (z[f"{key}_s"].copy(), z[f"{key}_pi"].copy())
    S, pi = _cache[key]
    return S.copy(), (pi / pi.sum()).copy()


def read_paml_matrix(path: str) -> tuple[np.ndarray, np.ndarray]:
    """PAML rate-file format: 19 lines of lower-triangular
    exchangeabilities (row i has i entries, i = 1..19), then 20
    frequencies (reference: Read_UserRatesAndFreqs, io.c)."""
    with open(path) as fh:
        vals = [float(tok) for tok in fh.read().split()]
    need = 190 + 20
    if len(vals) < need:
        raise ValueError(
            f"{path}: expected >= {need} numbers "
            f"(190 exchangeabilities + 20 freqs), got {len(vals)}"
        )
    S = np.zeros((20, 20))
    k = 0
    for i in range(1, 20):
        for j in range(i):
            S[i, j] = S[j, i] = vals[k]
            k += 1
    pi = np.asarray(vals[k:k + 20])
    return S, pi / pi.sum()
