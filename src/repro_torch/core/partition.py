"""Graph partitioning / community detection for GoGraph's divide phase.

The paper uses Rabbit-Partition by default and shows Metis/Louvain perform
similarly while stream-based Fennel lags (Fig. 13). We implement:

* ``label_propagation`` — synchronous LP over the symmetrized graph,
  vectorized with numpy (the default; community-quality close to Louvain on
  the power-law graphs the paper targets, and fast).
* ``louvain_like`` — one-level greedy modularity via repeated LP + community
  contraction (a light-weight stand-in for Louvain/Rabbit's merge hierarchy).
* ``fennel_like`` — streaming balanced partitioner (the paper's weakest
  competitor, reproduced for the Fig. 13 ablation).
* ``bfs_blocks`` — plain BFS chunking (no community structure; ablation).

All partitioners return integer labels, then ``enforce_max_size`` splits
oversized parts (BFS chunks) so the conquer phase's insertion cost stays
bounded, and ``compact_labels`` renumbers labels densely.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.graphs.graph import Graph


def compact_labels(labels: np.ndarray) -> np.ndarray:
    _, inv = np.unique(labels, return_inverse=True)
    return inv.astype(np.int32)


def _sym_csr(g: Graph) -> tuple[np.ndarray, np.ndarray]:
    """CSR of the symmetrized (undirected) graph."""
    a = np.concatenate([g.src, g.dst])
    b = np.concatenate([g.dst, g.src])
    order = np.argsort(a, kind="stable")
    indptr = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(a, minlength=g.n), out=indptr[1:])
    return indptr, b[order]


def label_propagation(g: Graph, rounds: int = 8, seed: int = 0) -> np.ndarray:
    """Synchronous label propagation, numpy-vectorized.

    Each round every vertex adopts the plurality label among its (undirected)
    neighbors; ties break toward the smaller label for determinism. A small
    random tie-noise on the first round avoids the all-labels-identical
    collapse LP is prone to on star-like graphs.
    """
    rng = np.random.default_rng(seed)
    labels = np.arange(g.n, dtype=np.int64)
    verts = np.arange(g.n, dtype=g.src.dtype)
    # self-vote breaks the synchronous-LP bipartite oscillation
    a = np.concatenate([g.dst, g.src, verts])  # receiver
    b = np.concatenate([g.src, g.dst, verts])  # sender
    if len(a) == 0:
        return labels.astype(np.int32)
    for r in range(rounds):
        lab_b = labels[b]
        # count votes per (receiver, label) pair
        key = a.astype(np.int64) * (g.n + 1) + lab_b
        uniq, counts = np.unique(key, return_counts=True)
        recv = uniq // (g.n + 1)
        lab = uniq % (g.n + 1)
        if r == 0:
            counts = counts.astype(np.float64) + rng.random(len(counts)) * 0.5
        # plurality with smaller-label tie-break: sort by (recv, -count, lab)
        order = np.lexsort((lab, -counts, recv))
        recv_s = recv[order]
        first = np.ones(len(recv_s), dtype=bool)
        first[1:] = recv_s[1:] != recv_s[:-1]
        winners_recv = recv_s[first]
        winners_lab = lab[order][first]
        new_labels = labels.copy()
        new_labels[winners_recv] = winners_lab
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return compact_labels(labels)


def louvain_like(g: Graph, levels: int = 2, rounds: int = 5, seed: int = 0) -> np.ndarray:
    """Multi-level LP: propagate, contract communities, propagate again.

    Approximates the Louvain/Rabbit merge hierarchy: the second level merges
    small communities that are densely interconnected.
    """
    labels = label_propagation(g, rounds=rounds, seed=seed)
    for lvl in range(1, levels):
        k = int(labels.max()) + 1 if g.n else 0
        if k <= 1:
            break
        # contracted multigraph between communities
        cs, cd = labels[g.src], labels[g.dst]
        keep = cs != cd
        if not keep.any():
            break
        gc = Graph(k, cs[keep].astype(np.int32), cd[keep].astype(np.int32))
        sup = label_propagation(gc, rounds=rounds, seed=seed + lvl)
        labels = sup[labels]
    return compact_labels(labels)


def fennel_like(g: Graph, k: int, gamma: float = 1.5, seed: int = 0) -> np.ndarray:
    """Streaming Fennel partitioner (paper Fig. 13's weak baseline).

    Vertices arrive in id order; each goes to the part maximizing
    |neighbors already in part| − alpha * gamma/2 * |part|^(gamma-1).
    """
    n = max(1, g.n)
    m = max(1, g.m)
    alpha = m * (k ** (gamma - 1)) / (n ** gamma)
    indptr, nbrs = _sym_csr(g)
    labels = -np.ones(g.n, dtype=np.int64)
    sizes = np.zeros(k, dtype=np.int64)
    scores = np.empty(k, dtype=np.float64)
    for v in range(g.n):
        scores[:] = -alpha * gamma / 2.0 * np.power(np.maximum(sizes, 1), gamma - 1)
        nb = nbrs[indptr[v]:indptr[v + 1]]
        placed = labels[nb]
        placed = placed[placed >= 0]
        if len(placed):
            np.add.at(scores, placed, 1.0)
        best = int(np.argmax(scores))
        labels[v] = best
        sizes[best] += 1
    return compact_labels(labels)


def bfs_blocks(g: Graph, block_size: int) -> np.ndarray:
    """Chunk a BFS traversal into fixed-size parts (no community signal)."""
    order = bfs_order(g)
    labels = np.empty(g.n, dtype=np.int32)
    labels[order] = np.arange(g.n, dtype=np.int32) // max(1, block_size)
    return compact_labels(labels)


def bfs_order(g: Graph, start: int | None = None) -> np.ndarray:
    """Undirected BFS visiting order, restarting at unvisited min-degree."""
    indptr, nbrs = _sym_csr(g)
    visited = np.zeros(g.n, dtype=bool)
    deg = indptr[1:] - indptr[:-1]
    by_deg = np.argsort(deg, kind="stable")
    order = np.empty(g.n, dtype=np.int64)
    pos = 0
    ptr = 0
    q: deque[int] = deque()
    if start is not None and g.n:
        q.append(start)
        visited[start] = True
    while pos < g.n:
        if not q:
            while ptr < g.n and visited[by_deg[ptr]]:
                ptr += 1
            if ptr >= g.n:
                break
            s = int(by_deg[ptr])
            visited[s] = True
            q.append(s)
        v = q.popleft()
        order[pos] = v
        pos += 1
        for u in nbrs[indptr[v]:indptr[v + 1]]:
            if not visited[u]:
                visited[u] = True
                q.append(int(u))
    return order[:pos]


def enforce_max_size(g: Graph, labels: np.ndarray, max_size: int, seed: int = 0) -> np.ndarray:
    """Split any community larger than max_size into BFS chunks."""
    labels = labels.astype(np.int64).copy()
    next_label = int(labels.max()) + 1 if g.n else 0
    sizes = np.bincount(labels)
    for c in np.where(sizes > max_size)[0]:
        members = np.where(labels == c)[0].astype(np.int32)
        sub, old_ids = g.subgraph(members)
        sub_order = bfs_order(sub)
        for chunk_start in range(0, len(sub_order), max_size):
            chunk = sub_order[chunk_start:chunk_start + max_size]
            if chunk_start == 0:
                continue  # first chunk keeps label c
            labels[old_ids[chunk]] = next_label
            next_label += 1
    return compact_labels(labels)


def partition(
    g: Graph,
    method: str = "labelprop",
    max_size: int = 4096,
    seed: int = 0,
    k_hint: int | None = None,
) -> np.ndarray:
    """Front door used by GoGraph. Returns dense community labels."""
    if method == "labelprop":
        labels = label_propagation(g, seed=seed)
    elif method == "louvain":
        labels = louvain_like(g, seed=seed)
    elif method == "fennel":
        k = k_hint or max(1, g.n // max(1, max_size))
        labels = fennel_like(g, k=k, seed=seed)
    elif method == "bfs":
        labels = bfs_blocks(g, block_size=max_size)
    else:
        raise ValueError(f"unknown partition method: {method}")
    return enforce_max_size(g, labels, max_size, seed=seed)
