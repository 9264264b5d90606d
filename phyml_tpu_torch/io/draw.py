"""Tree drawing: coordinate layout + PostScript output.

Reference: draw.c (DR_Draw_Tree draw.c:16, DR_Print_Tree_Postscript
draw.c:128, layout in DR_Get_X_Coord/DR_Get_Y_Coord) - a rectangular
phylogram: x = cumulative branch length from the root (scaled to the
page), y = tip rank for leaves / midpoint of children for internal
nodes, drawn with right-angle connectors, tip names at the leaves.
A host-only copy of phyml_tpu/io/draw.py (its output is byte for byte
the same, the creator line included).
"""

from __future__ import annotations

import numpy as np

PAGE_W, PAGE_H = 510.0, 700.0   # draw.c page box (72 dpi letter-ish)
MARGIN = 40.0


def tree_layout(topo, names):
    """Rectangular phylogram coordinates.

    Returns (xs [n_nodes], ys [n_nodes], order [n_otu tip ids],
    rv) for the rooted view's node indexing (tips 0..n-1 first).
    """
    rv = topo.rooted()
    n = topo.n_otu
    n_nodes = 2 * n - 1
    root = n_nodes - 1

    children = {n + i: (int(rv.child[i, 0]), int(rv.child[i, 1]))
                for i in range(n - 1)}

    xs = np.zeros(n_nodes)
    ys = np.zeros(n_nodes)
    order = []

    # iterative DFS for x (distance from root) and tip order
    stack = [(root, 0.0)]
    while stack:
        u, x = stack.pop()
        xs[u] = x
        if u < n:
            order.append(u)
        else:
            c0, c1 = children[u]
            stack.append((c1, x + max(rv.node_blen[c1], 0.0)))
            stack.append((c0, x + max(rv.node_blen[c0], 0.0)))

    for rank, tip in enumerate(order):
        ys[tip] = rank
    # postorder y for internal nodes: midpoint of the children
    for i in range(n - 1):
        u = n + i
        c0, c1 = children[u]
        ys[u] = 0.5 * (ys[c0] + ys[c1])
    return xs, ys, order, rv


def write_postscript(path, topo, names, title: str = "") -> str:
    """Write a self-contained one-page PostScript phylogram
    (DR_Print_Postscript_Header draw.c:57 + _Tree_Postscript :128)."""
    xs, ys, order, rv = tree_layout(topo, names)
    n = topo.n_otu
    xmax = float(xs.max()) or 1.0
    ymax = float(max(len(order) - 1, 1))
    name_w = 120.0
    sx = (PAGE_W - 2 * MARGIN - name_w) / xmax
    sy = (PAGE_H - 2 * MARGIN) / ymax

    def X(u):
        return MARGIN + xs[u] * sx

    def Y(u):
        return MARGIN + ys[u] * sy

    lines = []
    lines.append("%!PS-Adobe-3.0")
    lines.append("%%Creator: phyml-tpu")
    lines.append(f"%%Title: {title or 'phylogram'}")
    lines.append("%%Pages: 1")
    lines.append(f"%%BoundingBox: 0 0 {int(PAGE_W + 2 * MARGIN)} "
                 f"{int(PAGE_H + 2 * MARGIN)}")
    lines.append("%%EndComments")
    lines.append("%%Page: 1 1")
    lines.append("0.5 setlinewidth 1 setlinecap 1 setlinejoin")
    lines.append("/Helvetica findfont 8 scalefont setfont")

    root = 2 * n - 2
    for i in range(n - 1):
        u = n + i
        for c in (int(rv.child[i, 0]), int(rv.child[i, 1])):
            # right-angle connector: vertical at parent's x, then
            # horizontal to the child (draw.c:162 Pre recursion)
            lines.append(f"newpath {X(u):.2f} {Y(u):.2f} moveto "
                         f"{X(u):.2f} {Y(c):.2f} lineto "
                         f"{X(c):.2f} {Y(c):.2f} lineto stroke")
    for tip in range(n):
        lines.append(f"{X(tip) + 3:.2f} {Y(tip) - 2.5:.2f} moveto "
                     f"({_ps_escape(names[tip])}) show")
    # scale bar (draw.c prints the time/subst scale)
    bar = 10 ** np.floor(np.log10(xmax / 3.0)) if xmax > 0 else 1.0
    lines.append(f"newpath {MARGIN:.2f} {MARGIN / 2:.2f} moveto "
                 f"{MARGIN + bar * sx:.2f} {MARGIN / 2:.2f} "
                 f"lineto stroke")
    lines.append(f"{MARGIN:.2f} {MARGIN / 2 + 4:.2f} moveto "
                 f"({bar:g}) show")
    lines.append("showpage")
    lines.append("%%EOF")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def _ps_escape(s: str) -> str:
    return s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


def ascii_tree(topo, names, width: int = 72) -> str:
    """Terminal rendering (handy stand-in for the reference's
    Print_Tree ASCII output in utilities.c)."""
    xs, ys, order, rv = tree_layout(topo, names)
    n = topo.n_otu
    H = len(order)
    xmax = float(xs.max()) or 1.0
    maxname = max(len(names[t]) for t in range(n))
    W = max(16, width - maxname - 2)
    grid = [[" "] * (W + maxname + 2) for _ in range(H)]

    def col(u):
        return int(round(xs[u] / xmax * (W - 1)))

    def row(u):
        return int(round(ys[u]))

    for i in range(n - 1):
        u = n + i
        c0, c1 = int(rv.child[i, 0]), int(rv.child[i, 1])
        for c in (c0, c1):
            r, cu, cc = row(c), col(u), col(c)
            for x in range(cu, cc):
                grid[r][x] = "-"
        r0, r1 = sorted((row(c0), row(c1)))
        for r in range(r0, r1 + 1):
            if grid[r][col(u)] == " ":
                grid[r][col(u)] = "|"
        grid[row(c0)][col(u)] = "+"
        grid[row(c1)][col(u)] = "+"
    for t in range(n):
        r, c = row(t), col(t)
        label = names[t]
        for k, ch in enumerate(label):
            grid[r][min(c + 1 + k, len(grid[r]) - 1)] = ch
    return "\n".join("".join(r).rstrip() for r in grid)
