"""Directed growth with triad closure: the stand-in for a trust network.

Vertices arrive one at a time. Vertex v brings ``k_v`` links, drawn from a
discrete power law on 1..``k_max`` with exponent ``k_exponent`` and scaled
to the edge count asked for. Its first link goes to an earlier vertex drawn
in proportion to its degree plus one (preferential attachment); each
further link, with probability ``closure``, goes to a neighbour of the
vertex v linked to just before (triad closure, which makes the triangles
and the local communities of a social graph), and otherwise by preferential
attachment again; a pick that repeats one of v's links, or is v, is drawn
again by preferential attachment. A link is v -> t (v trusts t) with probability
``p_out``, else t -> v; with probability ``reciprocal`` the reverse edge is
added as well. Every vertex gets at least one link, so the graph is weakly
connected; the vertices with links one way only stay outside the largest
strongly connected component, as most of a trust network's users do.

The growth draws a few per cent more edges than asked; a seeded subset of
the links that were not a vertex's first is dropped to reach the count
exactly. Ids are scrambled last. The parameters are fitted to the source's
published statistics, which ``gpubench/tests`` hold it to.
"""
from __future__ import annotations

import numpy as np

from gpubench.graphs import EdgeList, scramble


def link_counts(n: int, total: float, k_max: int, exponent: float,
                rng: np.random.Generator) -> np.ndarray:
    """``n`` link counts from ``P(k) ~ (k + 1)^-exponent`` on 1..k_max,
    with the law's offset chosen so that their mean is ``total / n``."""
    k = np.arange(1, k_max + 1, dtype=np.float64)
    want = total / n
    lo, hi = -0.99, 1e4
    for _ in range(100):  # the mean grows with the offset
        mid = (lo + hi) / 2
        p = (k + mid) ** -exponent
        if (p * k).sum() / p.sum() < want:
            lo = mid
        else:
            hi = mid
    p = (k + hi) ** -exponent
    return rng.choice(k.astype(np.int64), size=n, p=p / p.sum())


def grow(n: int, links: np.ndarray, closure: float, p_out: float,
         reciprocal: float, rng: np.random.Generator):
    """The growth process. Returns ``(src, dst, first)``: the directed
    edges, no self-loop and no repeated pair, and a mask of the edges that
    were some vertex's first link."""
    total = int(links[1:].sum())
    u_pick = rng.random(total).tolist()
    u_close = (rng.random(total) < closure).tolist()
    v_out = (rng.random(n) < p_out).tolist()
    u_rec = (rng.random(total) < reciprocal).tolist()
    u_again = rng.random(total).tolist()  # redraws, in order, when a pick repeats
    # preferential attachment by in-degree for a trusting link, by
    # out-degree for a trusted one: each vertex once, then each edge's end
    ends = ([0], [0])  # [0]: heads (in-degree + 1), [1]: tails (out-degree + 1)
    # adj[0][x]: whom x trusts (x -> y), adj[1][x]: who trusts x (y -> x)
    adj: tuple[list[list[int]], ...] = ([[] for _ in range(n)], [[] for _ in range(n)])
    src: list[int] = []
    dst: list[int] = []
    first: list[bool] = []
    seen: set[int] = set()
    i = r = 0

    def add(a: int, b: int, is_first: bool) -> None:
        src.append(a)
        dst.append(b)
        first.append(is_first)
        ends[0].append(b)
        ends[1].append(a)
        adj[0][a].append(b)
        adj[1][b].append(a)

    for v in range(1, n):
        seen.clear()
        prev = 0
        out = v_out[v]
        pool = ends[0] if out else ends[1]
        near = adj[0] if out else adj[1]
        for j in range(int(links[v])):
            if j and u_close[i] and near[prev]:
                nb = near[prev]
                t = nb[int(u_pick[i] * len(nb))]
            else:
                t = pool[int(u_pick[i] * len(pool))]
            tries = 0
            while (t == v or t in seen) and tries < 8 and r < total:
                t = pool[int(u_again[r] * len(pool))]
                r += 1
                tries += 1
            if t != v and t not in seen:
                seen.add(t)
                a, b = (v, t) if out else (t, v)
                add(a, b, not j)
                if u_rec[i]:
                    add(b, a, False)
                prev = t
            i += 1
        ends[0].append(v)
        ends[1].append(v)
    return (np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.asarray(first, bool))


def generate(spec: dict, rng: np.random.Generator) -> EdgeList:
    """Exactly ``spec["vertices"]`` vertices and ``spec["edges"]`` edges,
    unit weights."""
    n, edges = int(spec["vertices"]), int(spec["edges"])
    rec = float(spec["reciprocal"])
    # a vertex links at most to those before it: on a small graph the
    # longest lists are cut to a twentieth of it (no cut at the published size)
    k_max = min(int(spec["k_max"]), n // 20)
    links = link_counts(n, edges * float(spec["spare"]) / (1 + rec),
                        k_max, float(spec["k_exponent"]), rng)
    src, dst, first = grow(n, links, float(spec["closure"]), float(spec["p_out"]),
                           rec, rng)
    extra = np.flatnonzero(~first)
    drop = len(src) - edges
    if drop < 0 or drop > len(extra):
        raise ValueError(f"growth left {len(src)} edges for {edges} asked")
    keep = np.ones(len(src), bool)
    keep[rng.choice(extra, size=drop, replace=False)] = False
    src, dst = scramble(n, src[keep], dst[keep], rng)
    return EdgeList(n, src, dst, np.ones(edges, np.float32))
