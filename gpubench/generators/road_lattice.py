"""A road map as a lattice with a random spanning tree and random extra roads."""
from __future__ import annotations

import numpy as np

from gpubench.graphs import EdgeList, scramble


def _lattice(n: int, cols: int) -> tuple[np.ndarray, np.ndarray]:
    """Undirected edges of row-major lattice with ``cols`` columns and ``n``
    vertices (the last row may be partial): each vertex to its right and
    lower neighbour."""
    v = np.arange(n)
    right = v[(v % cols != cols - 1) & (v + 1 < n)]
    down = v[v + cols < n]
    return (np.concatenate([right, down]),
            np.concatenate([right + 1, down + cols]))


def _spanning_tree(n: int, a: np.ndarray, b: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Kruskal over the edges in ``order``: a bool mask of the n - 1 edges
    of a spanning tree (the graph must be connected)."""
    parent = list(range(n))
    in_tree = np.zeros(len(a), bool)
    al, bl = a.tolist(), b.tolist()
    found = 0
    for i in order.tolist():
        x, y = al[i], bl[i]
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        while parent[y] != y:
            parent[y] = parent[parent[y]]
            y = parent[y]
        if x != y:
            parent[x] = y
            in_tree[i] = True
            found += 1
            if found == n - 1:
                break
    if found != n - 1:
        raise ValueError("the lattice is not connected")
    return in_tree


def generate(spec: dict, rng: np.random.Generator) -> EdgeList:
    """A road map as a lattice: ``spec["vertices"]`` vertices in rows of
    ``spec["cols"]``; a random spanning tree (Kruskal in a seeded order)
    keeps it connected, then further lattice edges drawn at random bring
    the undirected count to half of ``spec["arcs"]``; each edge is kept in
    both directions with one integer weight drawn uniformly from
    ``spec["weight_lo"]``..``spec["weight_hi"]``, stored as float32."""
    n, cols, arcs = int(spec["vertices"]), int(spec["cols"]), int(spec["arcs"])
    if arcs % 2:
        raise ValueError("arcs must be even: each road is kept both ways")
    a, b = _lattice(n, cols)
    undirected = arcs // 2
    if not n - 1 <= undirected <= len(a):
        raise ValueError(f"{undirected} roads do not fit a lattice of {len(a)}")
    tree = _spanning_tree(n, a, b, rng.permutation(len(a)))
    rest = np.flatnonzero(~tree)
    extra = rng.choice(rest, size=undirected - (n - 1), replace=False)
    keep = np.sort(np.concatenate([np.flatnonzero(tree), extra]))
    a, b = a[keep], b[keep]
    w = rng.integers(int(spec["weight_lo"]), int(spec["weight_hi"]) + 1,
                     size=undirected).astype(np.float32)
    src, dst = np.concatenate([a, b]), np.concatenate([b, a])
    src, dst = scramble(n, src, dst, rng)
    return EdgeList(n, src, dst, np.concatenate([w, w]))
