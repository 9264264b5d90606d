"""State spaces and ambiguity encodings for nucleotide / amino-acid data.

Behavioral parity with the reference tip encoding
(phyml lk.c:26-270, Init_Tips_At_One_Site_Nucleotides_Float /
_AA_Float): an observed state gets a one-hot vector over the state
space; an ambiguity code gets 1.0 on every compatible state; gaps and
unknowns get the all-ones vector.  Tip conditional-likelihood vectors
are exactly these 0/1 vectors.
"""

from __future__ import annotations

import numpy as np

NT = "nt"
AA = "aa"
GENERIC = "generic"

NT_STATES = "ACGT"
AA_STATES = "ARNDCQEGHILKMFPSTWYV"  # PhyML order (utilities.h AA indexing)
# "natural numbers" custom alphabet (-d generic, utilities.h:303
# GENERIC): digits then letters, supporting up to 36 states; the
# state count is inferred from the data (the reference reads digit
# states via Assign_State's GENERIC branch, utilities.c:3081+)
GENERIC_STATES = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"

# IUPAC nucleotide ambiguity codes -> compatible ACGT states
# (phyml lk.c:60-120).  U is T; anything unknown is a full gap.
_NT_AMBIG = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "M": "AC", "R": "AG", "W": "AT", "S": "CG", "Y": "CT", "K": "GT",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
    "N": "ACGT", "X": "ACGT", "?": "ACGT", "-": "ACGT", "O": "ACGT",
}

# Amino-acid ambiguity codes (phyml lk.c:180-260): B = N or D,
# Z = Q or E, J = I or L, X/?/- = anything.
_AA_AMBIG = {c: c for c in AA_STATES}
_AA_AMBIG.update({
    "B": "ND", "Z": "QE", "J": "IL",
    "X": AA_STATES, "?": AA_STATES, "-": AA_STATES, "*": AA_STATES,
})


def n_states(datatype: str) -> int:
    if datatype == NT:
        return 4
    if datatype == AA:
        return 20
    raise ValueError(f"unknown datatype {datatype!r}")


def state_alphabet(datatype: str) -> str:
    return NT_STATES if datatype == NT else AA_STATES


def ambiguity_table(datatype: str) -> np.ndarray:
    """[256, ns] float32 table: ASCII byte -> tip partial vector."""
    ns = n_states(datatype)
    alpha = state_alphabet(datatype)
    amb = _NT_AMBIG if datatype == NT else _AA_AMBIG
    table = np.zeros((256, ns), dtype=np.float32)
    for code, states in amb.items():
        row = np.zeros(ns, dtype=np.float32)
        for s in states:
            row[alpha.index(s)] = 1.0
        table[ord(code)] = row
        table[ord(code.lower())] = row
    return table


def encode_sequences(seqs: list[str], datatype: str) -> np.ndarray:
    """Encode raw sequence strings -> tip partials [n_otu, n_sites, ns]."""
    table = ambiguity_table(datatype)
    mat = np.frombuffer(
        "".join(seqs).encode("ascii"), dtype=np.uint8
    ).reshape(len(seqs), -1)
    enc = table[mat]
    bad = enc.sum(axis=-1) == 0.0
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise ValueError(
            f"unrecognized character {chr(mat[i, j])!r} in sequence {i} "
            f"site {j} for datatype {datatype!r}"
        )
    return enc


def is_ambiguous(enc: np.ndarray) -> np.ndarray:
    """[n_otu, n_sites] bool: more than one compatible state."""
    return enc.sum(axis=-1) > 1.0


def state_index(enc: np.ndarray) -> np.ndarray:
    """[n_otu, n_sites] int32: argmax state for unambiguous columns
    (undefined where ambiguous)."""
    return enc.argmax(axis=-1).astype(np.int32)


def encode_generic(seqs: list[str],
                   ns: int | None = None) -> tuple[np.ndarray, int]:
    """Encode a custom-alphabet ("natural numbers") alignment.

    States are single characters from GENERIC_STATES (0-9, then
    A-Z); '?', '-', 'X' and '.' are full ambiguity.  The state count
    is the highest state seen + 1 unless given.  Returns
    (enc [n_otu, n_sites, ns], ns).  Reference: -d generic with
    whichmodel=JC69 over the inferred alphabet (cl.c:929-932,
    init.c:1519-1533)."""
    mat = np.frombuffer(
        "".join(seqs).upper().encode("ascii"), dtype=np.uint8
    ).reshape(len(seqs), -1)
    idx = np.full(256, -2, dtype=np.int64)          # -2 = invalid
    for i, c in enumerate(GENERIC_STATES):
        idx[ord(c)] = i
    # '?', '-', '.' and 'X' are full ambiguity ('X' is the
    # conventional missing-data code; alphabets needing 34+ states
    # should avoid it as a state letter)
    for c in "?-.X":
        idx[ord(c)] = -1                            # -1 = ambiguous
    states = idx[mat]
    if (states == -2).any():
        i, j = np.argwhere(states == -2)[0]
        raise ValueError(
            f"unrecognized character {chr(mat[i, j])!r} in sequence "
            f"{i} site {j} for the generic datatype")
    seen_max = int(states.max()) if (states >= 0).any() else 0
    if ns is None:
        ns = max(2, seen_max + 1)
    elif seen_max >= ns:
        raise ValueError(
            f"generic state {seen_max} out of range for ns={ns}")
    enc = np.zeros(states.shape + (ns,), dtype=np.float32)
    amb = states < 0
    enc[~amb, states[~amb]] = 1.0
    enc[amb] = 1.0
    return enc, ns
