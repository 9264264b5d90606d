"""FASTA alignment reader/writer."""

from __future__ import annotations


def parse_fasta(text: str) -> tuple[list[str], list[str]]:
    names: list[str] = []
    seqs: list[str] = []
    cur: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if names:
                seqs.append("".join(cur))
            names.append(line[1:].split()[0])
            cur = []
        else:
            cur.append(line.replace(" ", ""))
    if names:
        seqs.append("".join(cur))
    if not names:
        raise ValueError("no FASTA records found")
    lens = {len(s) for s in seqs}
    if len(lens) != 1:
        raise ValueError(f"FASTA sequences have unequal lengths: {sorted(lens)}")
    return names, seqs


def write_fasta(names: list[str], seqs: list[str], width: int = 60) -> str:
    out = []
    for n, s in zip(names, seqs):
        out.append(f">{n}")
        out.extend(s[i:i + width] for i in range(0, len(s), width))
    return "\n".join(out) + "\n"
