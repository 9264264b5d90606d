"""PHYLIP alignment reader (interleaved and sequential).

Parity target: the reference reader (phyml io.c:1052 Get_Seq,
io.c:1532 Read_Seq_Interleaved, io.c:1401 Read_Seq_Sequential), which
accepts relaxed PHYLIP: a header line "n_otu n_sites", taxon names
terminated by whitespace, sequence characters with spaces and digits
ignored, interleaved blocks separated by blank lines.  Like the
reference, interleaved is the default and sequential is an explicit
option (reference flag -q).
"""

from __future__ import annotations

import re


def _clean(chunk: str, keep_digits: bool = False) -> str:
    """Strip whitespace and (unless the datatype uses digit states,
    e.g. -d generic) digits (position rulers) from sequence text."""
    if keep_digits:
        return re.sub(r"\s", "", chunk)
    return re.sub(r"[\s\d]", "", chunk)


def parse_phylip(
    text: str, interleaved: bool = True, keep_digits: bool = False
) -> tuple[list[str], list[str]]:
    """Return (names, sequences)."""
    lines = [ln for ln in text.splitlines()]
    # Header: first non-blank line.
    hi = 0
    while hi < len(lines) and not lines[hi].strip():
        hi += 1
    header = lines[hi].split() if hi < len(lines) else []
    if len(header) < 2:
        raise ValueError("bad PHYLIP header: expected 'n_otu n_sites'")
    n_otu, n_sites = int(header[0]), int(header[1])
    body = [ln for ln in lines[hi + 1:]]

    if interleaved:
        names, seqs = _parse_interleaved(body, n_otu, keep_digits)
    else:
        names, seqs = _parse_sequential(body, n_otu, n_sites, keep_digits)

    for nm, s in zip(names, seqs):
        if len(s) < n_sites:
            raise ValueError(
                f"PHYLIP: sequence {nm!r} has {len(s)} sites, "
                f"expected {n_sites}"
            )
    return names, [s[:n_sites] for s in seqs]


def _parse_interleaved(body: list[str], n_otu: int,
                       keep_digits: bool = False):
    names: list[str] = []
    seqs: list[str] = []
    row = 0
    in_first_block = True
    for line in body:
        if not line.strip():
            if names:            # blank line = block separator
                row = 0
                in_first_block = False
            continue
        if in_first_block and len(names) < n_otu:
            parts = line.split(None, 1)
            names.append(parts[0])
            seqs.append(_clean(parts[1], keep_digits)
                        if len(parts) > 1 else "")
            if len(names) == n_otu:
                in_first_block = False
                row = 0
        else:
            seqs[row % n_otu] += _clean(line, keep_digits)
            row += 1
    if len(names) != n_otu:
        raise ValueError(f"PHYLIP: expected {n_otu} taxa, found {len(names)}")
    return names, seqs


def _parse_sequential(body: list[str], n_otu: int, n_sites: int,
                      keep_digits: bool = False):
    names: list[str] = []
    seqs: list[str] = []
    cur = ""
    started = False
    for line in body:
        if not line.strip():
            continue
        if not started or len(cur) >= n_sites:
            if started:
                seqs.append(cur)
            parts = line.split(None, 1)
            names.append(parts[0])
            cur = _clean(parts[1], keep_digits) \
                if len(parts) > 1 else ""
            started = True
        else:
            cur += _clean(line, keep_digits)
    if started:
        seqs.append(cur)
    if len(seqs) != n_otu:
        raise ValueError(
            f"PHYLIP sequential: expected {n_otu} taxa, parsed {len(seqs)}"
        )
    return names, seqs


def parse_phylip_multi(
    text: str, n_sets: int, interleaved: bool = True,
    keep_digits: bool = False,
) -> list[tuple[list[str], list[str]]]:
    """Parse `n_sets` consecutive data sets from one PHYLIP file
    (reference: the per-data-set loop of main.c:108 with -n/--multiple,
    re-calling Get_Seq on the same open file).  Each set has its own
    'n_otu n_sites' header."""
    lines = text.splitlines()
    pos = 0
    out: list[tuple[list[str], list[str]]] = []
    for _ in range(n_sets):
        while pos < len(lines) and not lines[pos].strip():
            pos += 1
        if pos >= len(lines):
            raise ValueError(
                f"PHYLIP: expected {n_sets} data sets, found {len(out)}"
            )
        header = lines[pos].split()
        if len(header) < 2:
            raise ValueError("bad PHYLIP header: expected 'n_otu n_sites'")
        n_otu, n_sites = int(header[0]), int(header[1])
        pos += 1

        names: list[str] = []
        seqs: list[str] = []
        if interleaved:
            row = 0
            in_first = True
            while pos < len(lines):
                line = lines[pos]
                if not line.strip():
                    if names:
                        row = 0
                        in_first = False
                    pos += 1
                    continue
                if (names and not in_first
                        and all(len(s) >= n_sites for s in seqs)):
                    break  # next dataset's header
                if in_first and len(names) < n_otu:
                    parts = line.split(None, 1)
                    names.append(parts[0])
                    seqs.append(_clean(parts[1], keep_digits)
                                if len(parts) > 1 else "")
                    if len(names) == n_otu:
                        in_first = False
                        row = 0
                else:
                    seqs[row % n_otu] += _clean(line, keep_digits)
                    row += 1
                pos += 1
        else:
            cur = ""
            started = False
            while pos < len(lines) and len(seqs) < n_otu:
                line = lines[pos]
                if not line.strip():
                    pos += 1
                    continue
                if not started or len(cur) >= n_sites:
                    if started:
                        seqs.append(cur)
                        if len(seqs) == n_otu:
                            break
                    parts = line.split(None, 1)
                    names.append(parts[0])
                    cur = (_clean(parts[1], keep_digits)
                           if len(parts) > 1 else "")
                    started = True
                else:
                    cur += _clean(line, keep_digits)
                pos += 1
            if started and len(seqs) < n_otu:
                seqs.append(cur)
        if len(names) != n_otu or any(len(s) < n_sites for s in seqs):
            raise ValueError(
                f"PHYLIP multi: data set {len(out)} incomplete "
                f"({len(names)}/{n_otu} taxa)"
            )
        out.append((names, [s[:n_sites] for s in seqs]))
    return out


def write_phylip(names: list[str], seqs: list[str]) -> str:
    """Write interleaved PHYLIP matching the reference's output shape
    (io.c Print_CSeq): 60 columns per row in blocks of 10."""
    n_otu, n_sites = len(seqs), len(seqs[0])
    out = [f" {n_otu} {n_sites}"]
    width = max(len(n) for n in names) + 3
    for start in range(0, n_sites, 60):
        for i in range(n_otu):
            chunk = seqs[i][start:start + 60]
            grouped = " ".join(
                chunk[j:j + 10] for j in range(0, len(chunk), 10)
            )
            prefix = names[i].ljust(width) if start == 0 else " " * width
            out.append(prefix + grouped)
        out.append("")
    return "\n".join(out) + "\n"
