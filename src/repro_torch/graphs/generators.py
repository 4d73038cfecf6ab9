"""Synthetic graph generators.

The paper evaluates on six real web/social graphs (Table I) plus synthetic
Barabási–Albert graphs (Fig. 12). This container has no network access, so all
experiments run on synthetic generators with the same qualitative structure:
power-law degree distributions, communities, and (for SSSP) weighted variants.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph


def _dedup(n: int, src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst
    _, first = np.unique(key, return_index=True)
    first.sort()
    return src[first], dst[first]


def barabasi_albert(n: int, m: int, seed: int = 0, directed: bool = True) -> Graph:
    """BA preferential attachment (paper §V-H uses this for degree sweeps).

    Each new vertex attaches to `m` existing vertices picked via the repeated-
    nodes trick (Batagelj–Brandes), giving the standard power-law tail. Edges
    are oriented new->old then 50% flipped so both directions occur, matching
    how the paper treats directed iterative workloads.
    """
    rng = np.random.default_rng(seed)
    if n <= m:
        raise ValueError("n must exceed m")
    repeated: list[int] = []
    srcs = np.empty(( (n - m - 1) * m + m,), dtype=np.int32)
    dsts = np.empty_like(srcs)
    e = 0
    # seed clique-ish star among first m+1 vertices
    for v in range(m):
        srcs[e], dsts[e] = m, v
        repeated.extend((m, v))
        e += 1
    for v in range(m + 1, n):
        targets: set[int] = set()
        while len(targets) < m:
            if rng.random() < 0.9 and repeated:
                targets.add(repeated[rng.integers(len(repeated))])
            else:
                targets.add(int(rng.integers(v)))
        for t in targets:
            srcs[e], dsts[e] = v, t
            repeated.extend((v, t))
            e += 1
    src, dst = srcs[:e], dsts[:e]
    if directed:
        flip = rng.random(e) < 0.5
        src2 = np.where(flip, dst, src)
        dst2 = np.where(flip, src, dst)
        src, dst = src2, dst2
    src, dst = _dedup(n, src, dst)
    return Graph(n, src, dst)


def erdos_renyi(n: int, avg_degree: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    src = rng.integers(0, n, size=m, dtype=np.int32)
    dst = rng.integers(0, n, size=m, dtype=np.int32)
    src, dst = _dedup(n, src, dst)
    return Graph(n, src, dst)


def powerlaw_cluster(n: int, m: int, p: float = 0.3, seed: int = 0) -> Graph:
    """BA-like growth with triad closure -> communities + power law.

    This is the closest synthetic stand-in for the paper's web graphs
    (indochina / sk-2005): heavy tail *and* strong local clustering, which is
    what makes partition-based reordering (Rabbit, GoGraph step 2) matter.
    """
    rng = np.random.default_rng(seed)
    repeated: list[int] = []
    src_l: list[int] = []
    dst_l: list[int] = []
    for v in range(1, min(m + 1, n)):
        src_l.append(v)
        dst_l.append(v - 1)
        repeated.extend((v, v - 1))
    for v in range(m + 1, n):
        last_target = None
        made = 0
        while made < m:
            if last_target is not None and rng.random() < p:
                # triad closure: connect to a neighbor of the last target
                cand = [repeated[rng.integers(len(repeated))]]
                t = cand[0]
            else:
                t = repeated[rng.integers(len(repeated))] if repeated else int(rng.integers(v))
            if t != v:
                src_l.append(v)
                dst_l.append(t)
                repeated.extend((v, t))
                last_target = t
                made += 1
    src = np.asarray(src_l, dtype=np.int32)
    dst = np.asarray(dst_l, dtype=np.int32)
    flip = rng.random(len(src)) < 0.5
    src2 = np.where(flip, dst, src).astype(np.int32)
    dst2 = np.where(flip, src, dst).astype(np.int32)
    src, dst = _dedup(n, src2, dst2)
    return Graph(n, src, dst)


def community_graph(
    n: int,
    n_communities: int,
    avg_degree: float = 8.0,
    p_intra: float = 0.9,
    seed: int = 0,
) -> Graph:
    """Planted-partition graph: p_intra of edges stay inside a community."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_communities, size=n)
    members: list[np.ndarray] = [np.where(comm == c)[0] for c in range(n_communities)]
    m = int(n * avg_degree)
    src = rng.integers(0, n, size=m, dtype=np.int32)
    intra = rng.random(m) < p_intra
    dst = np.empty(m, dtype=np.int32)
    for i in range(m):
        if intra[i]:
            mem = members[comm[src[i]]]
            dst[i] = mem[rng.integers(len(mem))] if len(mem) else rng.integers(n)
        else:
            dst[i] = rng.integers(n)
    src, dst = _dedup(n, src, dst)
    return Graph(n, src, dst)


def grid_2d(rows: int, cols: int, seed: int = 0) -> Graph:
    """Directed 2D grid (right+down) — a worst case for hub-based reorderers."""
    n = rows * cols
    vid = np.arange(n).reshape(rows, cols)
    src = np.concatenate([vid[:, :-1].ravel(), vid[:-1, :].ravel()])
    dst = np.concatenate([vid[:, 1:].ravel(), vid[1:, :].ravel()])
    rng = np.random.default_rng(seed)
    flip = rng.random(len(src)) < 0.25
    s = np.where(flip, dst, src).astype(np.int32)
    d = np.where(flip, src, dst).astype(np.int32)
    return Graph(n, s, d)


def with_random_weights(g: Graph, lo: float = 1.0, hi: float = 10.0, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    w = rng.uniform(lo, hi, size=g.m).astype(np.float32)
    return Graph(g.n, g.src.copy(), g.dst.copy(), w)


def scrambled(g: Graph, seed: int = 0) -> Graph:
    """Random relabeling — used to model a 'bad' default vertex order."""
    rng = np.random.default_rng(seed)
    rank = rng.permutation(g.n).astype(np.int32)
    return g.relabel(rank)


# Registry used by benchmarks / examples (the reference's, same names and
# calls). Sizes chosen so the full paper benchmark suite finishes on a single
# CPU core; the generators scale to arbitrarily large graphs.
DATASETS = {
    # name: thunk  (named after the paper dataset they stand in for)
    "ic-like": lambda: powerlaw_cluster(8_000, 6, p=0.5, seed=1),       # indochina-ish
    "sk-like": lambda: powerlaw_cluster(20_000, 6, p=0.4, seed=2),      # sk-2005-ish
    "gl-like": lambda: barabasi_albert(30_000, 5, seed=3),              # google-ish
    "wk-like": lambda: barabasi_albert(50_000, 3, seed=4),              # wiki-ish
    "cp-like": lambda: erdos_renyi(40_000, 5.0, seed=5),                # cit-patents-ish
    "lj-like": lambda: community_graph(40_000, 200, 7.0, 0.85, seed=6), # livejournal-ish
}


def load_dataset(name: str) -> Graph:
    return DATASETS[name]()
