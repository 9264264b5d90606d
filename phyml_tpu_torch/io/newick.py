"""Newick tree parse / write.

Parity target: the reference reader/writer (phyml io.c:24 Read_Tree,
io.c:714 Write_Tree): branch lengths after ':', internal-node labels
used as support values, bracketed comments skipped, unrooted
(trifurcating root) and rooted (bifurcating root) inputs both accepted.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class NewickNode:
    name: str | None = None
    length: float | None = None
    support: str | None = None
    children: list["NewickNode"] = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children


def parse_newick(text: str) -> NewickNode:
    s = text.strip()
    if not s:
        raise ValueError("empty newick string")
    pos = 0

    def skip_ws() -> None:
        nonlocal pos
        while pos < len(s) and (s[pos].isspace() or s[pos] == "["):
            if s[pos] == "[":  # comment
                depth = 1
                pos += 1
                while pos < len(s) and depth:
                    if s[pos] == "[":
                        depth += 1
                    elif s[pos] == "]":
                        depth -= 1
                    pos += 1
            else:
                pos += 1

    def read_token() -> str:
        nonlocal pos
        skip_ws()
        if pos < len(s) and s[pos] in "'\"":
            quote = s[pos]
            pos += 1
            start = pos
            while pos < len(s) and s[pos] != quote:
                pos += 1
            tok = s[start:pos]
            pos += 1
            return tok
        start = pos
        while pos < len(s) and s[pos] not in "(),:;[":
            pos += 1
        return s[start:pos].strip()

    def read_clade() -> NewickNode:
        nonlocal pos
        skip_ws()
        node = NewickNode()
        if pos < len(s) and s[pos] == "(":
            pos += 1
            while True:
                node.children.append(read_clade())
                skip_ws()
                if pos >= len(s):
                    raise ValueError("unbalanced parentheses in newick")
                if s[pos] == ",":
                    pos += 1
                    continue
                if s[pos] == ")":
                    pos += 1
                    break
                raise ValueError(f"unexpected char {s[pos]!r} at {pos}")
            label = read_token()
            if label:
                node.support = label  # internal label = support (io.c:259)
                node.name = label
        else:
            node.name = read_token()
            if not node.name:
                raise ValueError(f"expected taxon name at position {pos}")
        skip_ws()
        if pos < len(s) and s[pos] == ":":
            pos += 1
            node.length = float(read_token())
        skip_ws()
        return node

    root = read_clade()
    skip_ws()
    if pos < len(s) and s[pos] == ";":
        pos += 1
    return root


def write_newick(
    node: NewickNode,
    with_support: bool = False,
    fmt: str = "%.8f",
) -> str:
    def rec(n: NewickNode) -> str:
        if n.is_leaf:
            body = n.name or ""
        else:
            body = "(" + ",".join(rec(c) for c in n.children) + ")"
            if with_support and n.support is not None:
                body += str(n.support)
        if n.length is not None:
            body += ":" + (fmt % n.length)
        return body

    return rec(node) + ";"


def leaf_names(node: NewickNode) -> list[str]:
    out: list[str] = []

    def rec(n: NewickNode) -> None:
        if n.is_leaf:
            out.append(n.name)
        for c in n.children:
            rec(c)

    rec(node)
    return out


def parse_newick_labeled(text: str) -> dict[str, frozenset]:
    """Parse a tree whose internal nodes carry labels (the ancestral
    tree written by --ancestral, ancestral.c:582-588) and return
    {internal label: frozenset of descendant tip names}."""
    root = parse_newick(text)
    out: dict[str, frozenset] = {}

    def rec(n: NewickNode) -> frozenset:
        if n.is_leaf:
            return frozenset([n.name])
        tips = frozenset().union(*(rec(c) for c in n.children))
        if n.support:
            out[str(n.support)] = tips
        return tips

    rec(root)
    return out


def insert_duplicate_leaves(
    text: str, pairs: list[tuple[str, str]],
) -> str:
    """Graft removed duplicate taxa back into a newick string at zero
    distance from their kept twin (reference: Insert_Duplicates,
    called at main.c:389 after the search ran on the reduced data).
    `pairs` is [(duplicate_name, twin_name), ...]; each duplicate
    becomes a cherry (TWIN:0, DUP:0) carrying the twin's original
    pendant edge length."""
    root = parse_newick(text)

    def rec(n: NewickNode) -> None:
        for i, c in enumerate(list(n.children)):
            if c.is_leaf and c.name in grafts:
                pendant = c.length
                node = c
                node.length = 0.0
                for dup in grafts[c.name]:
                    node = NewickNode(
                        name=None, length=0.0,
                        children=[node,
                                  NewickNode(name=dup, length=0.0)])
                node.length = pendant
                n.children[i] = node
            else:
                rec(c)

    grafts: dict[str, list[str]] = {}
    for dup, twin in pairs:
        grafts.setdefault(twin, []).append(dup)
    rec(root)
    # with_support=True: keep any internal support labels
    # (bootstrap/aLRT/aBayes) the input carried — harmless when none
    # are present (reference Insert_Duplicates preserves them too)
    return write_newick(root, with_support=True)
