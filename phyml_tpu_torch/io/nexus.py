"""Minimal NEXUS parser: DATA/CHARACTERS matrix and TREES blocks.

Parity target: the reference token-level NEXUS reader
(nexus.c:225 Read_Nexus_Format and the per-command handlers for
dimensions / format / matrix / translate / tree).
"""

from __future__ import annotations

import re

from phyml_tpu_torch import datatypes


def _strip_comments(text: str) -> str:
    out, depth = [], 0
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out)


def parse_nexus_alignment(text: str) -> tuple[list[str], list[str], str]:
    """Return (names, sequences, datatype)."""
    body = _strip_comments(text)
    m = re.search(
        r"begin\s+(?:data|characters)\s*;(.*?)end\s*;",
        body, re.IGNORECASE | re.DOTALL,
    )
    if not m:
        raise ValueError("no DATA/CHARACTERS block in NEXUS file")
    block = m.group(1)

    datatype = datatypes.NT
    fm = re.search(r"format([^;]*);", block, re.IGNORECASE | re.DOTALL)
    interleave = False
    missing, gap = "?", "-"
    if fm:
        opts = fm.group(1)
        dm = re.search(r"datatype\s*=\s*(\w+)", opts, re.IGNORECASE)
        if dm and dm.group(1).lower() in ("protein", "aa", "amino"):
            datatype = datatypes.AA
        interleave = bool(
            re.search(r"interleave(\s*=\s*yes)?", opts, re.IGNORECASE)
        )
        mm = re.search(r"missing\s*=\s*(\S)", opts, re.IGNORECASE)
        if mm:
            missing = mm.group(1)
        gm = re.search(r"gap\s*=\s*(\S)", opts, re.IGNORECASE)
        if gm:
            gap = gm.group(1)

    mm_ = re.search(r"matrix(.*?);", block, re.IGNORECASE | re.DOTALL)
    if not mm_:
        raise ValueError("no MATRIX command in NEXUS data block")
    names: list[str] = []
    seqs: dict[str, str] = {}
    for line in mm_.group(1).splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            continue
        name = parts[0].strip("'\"")
        seq = re.sub(r"\s", "", parts[1])
        seq = seq.replace(missing, "?").replace(gap, "-")
        if name not in seqs:
            names.append(name)
            seqs[name] = seq
        else:
            seqs[name] += seq
    return names, [seqs[n] for n in names], datatype


def parse_nexus_trees(text: str) -> list[tuple[str, str]]:
    """Return [(tree_name, newick_string)] with TRANSLATE applied."""
    body = _strip_comments(text)
    m = re.search(
        r"begin\s+trees\s*;(.*?)end\s*;", body, re.IGNORECASE | re.DOTALL
    )
    if not m:
        return []
    block = m.group(1)
    translate: dict[str, str] = {}
    tm = re.search(r"translate(.*?);", block, re.IGNORECASE | re.DOTALL)
    if tm:
        for pair in tm.group(1).split(","):
            toks = pair.split()
            if len(toks) >= 2:
                translate[toks[0]] = toks[1].strip("'\"")
    trees = []
    for tmatch in re.finditer(
        r"tree\s+(\S+)\s*=\s*(?:\[[^\]]*\]\s*)?([^;]+);",
        block, re.IGNORECASE,
    ):
        name, nwk = tmatch.group(1), tmatch.group(2) + ";"
        if translate:
            nwk = re.sub(
                r"(?<=[(,])\s*([^\s(),:]+)",
                lambda mo: translate.get(mo.group(1), mo.group(1)),
                nwk,
            )
        trees.append((name, nwk))
    return trees
