"""Competitor reordering methods from the paper's evaluation (§V-A); port of
``repro.core.baselines`` (numpy, identical ranks per seed).

All functions return a rank array (rank[v] = ordinal p(v)).

* ``default_order``   — original ids (the paper's baseline of unit runtime).
* ``random_order``    — random permutation; M is |E|/2 in expectation, the
                         paper's effectiveness yardstick (§IV-B).
* ``degree_sort``     — descending-degree relabeling.
* ``hub_sort``        — Hub Sorting [48]: hubs (deg > avg) sorted descending at
                         the front; non-hub relative order preserved.
* ``hub_cluster``     — Hub Clustering [49]: hubs clustered contiguously at the
                         front in original relative order.
* ``rabbit_like``     — Rabbit [44]: community detection + community-major
                         layout, BFS within community (locality only).
* ``gorder_like``     — Gorder [41]: greedy sliding-window neighbor-affinity
                         maximization (priority-queue implementation).
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core import partition as part_mod
from repro_torch.core.gograph import _community_bfs_order
from repro_torch.graphs.graph import Graph, order_to_rank


def default_order(g: Graph) -> np.ndarray:
    return np.arange(g.n, dtype=np.int64)


def random_order(g: Graph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(g.n).astype(np.int64)


def degree_sort(g: Graph) -> np.ndarray:
    deg = g.degrees()
    order = np.lexsort((np.arange(g.n), -deg))
    return order_to_rank(order)


def hub_sort(g: Graph) -> np.ndarray:
    deg = g.degrees()
    avg = deg.mean() if g.n else 0.0
    hubs = np.where(deg > avg)[0]
    non = np.where(deg <= avg)[0]
    hubs = hubs[np.argsort(-deg[hubs], kind="stable")]
    order = np.concatenate([hubs, non])
    return order_to_rank(order)


def hub_cluster(g: Graph) -> np.ndarray:
    deg = g.degrees()
    avg = deg.mean() if g.n else 0.0
    hubs = np.where(deg > avg)[0]
    non = np.where(deg <= avg)[0]
    order = np.concatenate([hubs, non])  # original relative order both sides
    return order_to_rank(order)


def rabbit_like(g: Graph, seed: int = 0) -> np.ndarray:
    """Community-major layout: communities ordered by size desc, members in
    BFS order. Captures Rabbit's cache goal (locality) but — unlike GoGraph —
    is direction-blind, so it does not optimize M(.)."""
    labels = part_mod.louvain_like(g, seed=seed)
    k = int(labels.max()) + 1 if g.n else 0
    sym_indptr, sym_nbrs = part_mod._sym_csr(g)
    in_deg = g.in_degrees()
    sizes = np.bincount(labels, minlength=k)
    comm_order = np.argsort(-sizes, kind="stable")
    chunks = []
    for c in comm_order:
        members = np.where(labels == c)[0]
        chunks.append(_community_bfs_order(members, sym_indptr, sym_nbrs, in_deg))
    order = np.concatenate(chunks) if chunks else np.empty(0, dtype=np.int64)
    return order_to_rank(order)


def gorder_like(g: Graph, window: int = 5) -> np.ndarray:
    """Greedy Gorder: repeatedly append the vertex with the highest affinity
    (shared edges) to the last `window` placed vertices. Lazy max-heap with
    stale-entry skipping; O((n + m·w) log n)."""
    n = g.n
    sym_indptr, sym_nbrs = part_mod._sym_csr(g)
    score = np.zeros(n, dtype=np.int64)
    placed = np.zeros(n, dtype=bool)
    heap: list[tuple[int, int]] = [(0, v) for v in range(n)]
    heapq.heapify(heap)
    recent: list[int] = []
    order = np.empty(n, dtype=np.int64)

    def bump(v: int, d: int) -> None:
        score[v] += d
        if not placed[v] and d > 0:
            heapq.heappush(heap, (-int(score[v]), v))

    for pos in range(n):
        while heap:
            neg_s, v = heap[0]
            if placed[v] or -neg_s != score[v]:
                heapq.heappop(heap)
                continue
            break
        if not heap:  # all stale: pick any unplaced
            v = int(np.where(~placed)[0][0])
        else:
            _, v = heapq.heappop(heap)
        placed[v] = True
        order[pos] = v
        recent.append(v)
        for u in sym_nbrs[sym_indptr[v]:sym_indptr[v + 1]]:
            if not placed[u]:
                bump(int(u), 1)
        if len(recent) > window:
            old = recent.pop(0)
            for u in sym_nbrs[sym_indptr[old]:sym_indptr[old + 1]]:
                if not placed[u]:
                    score[u] -= 1  # lazy: heap entry goes stale
    return order_to_rank(order)


# Registry used by benchmarks (paper Fig. 5/6 competitor set + GoGraph).
def all_reorderers(seed: int = 0) -> dict:
    from repro_torch.core.gograph import gograph_order

    return {
        "Default": lambda g: default_order(g),
        "Random": lambda g: random_order(g, seed=seed),
        "DegSort": degree_sort,
        "HubSort": hub_sort,
        "HubCluster": hub_cluster,
        "Rabbit": lambda g: rabbit_like(g, seed=seed),
        "Gorder": gorder_like,
        "GoGraph": lambda g: gograph_order(g),
    }
