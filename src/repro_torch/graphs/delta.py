"""Batched graph mutations for evolving-graph serving (port of
``repro.graphs.delta``; numpy, identical outputs per seed).

A :class:`GraphDelta` is one *batch* of updates — edge insertions, edge
deletions, edge reweights, and appended vertices — the unit at which a
serving deployment absorbs change (Maiter's delta-based accumulative model;
the InstantGNN evolving-PPR setting). Applying a delta keeps every surviving
vertex id stable and appends new vertices at the end, which is what lets the
incremental engine (`repro_torch.engine.incremental`) overlay a previously
converged state onto the mutated graph.

Deltas address edges by endpoint pair ``(src, dst)``; parallel edges are not
distinguished (the generators dedupe them), so a deletion removes every copy
of the pair and a reweight retargets all of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graphs.graph import Graph


def _as_edges(src, dst) -> tuple[np.ndarray, np.ndarray]:
    src = np.asarray(src, dtype=np.int32).reshape(-1)
    dst = np.asarray(dst, dtype=np.int32).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError("edge src/dst arrays must have the same length")
    return src, dst


_EMPTY_I = np.empty(0, np.int32)
_EMPTY_F = np.empty(0, np.float32)


def out_closure(
    src: np.ndarray, dst: np.ndarray, seeds: np.ndarray, n: int,
    depth: int = 1,
) -> np.ndarray:
    """bool[n] — ``seeds`` plus every vertex within ``depth`` out-edge hops.

    THE out-neighborhood closure helper: the megakernel frontier seeding
    (`engine.async_block.AsyncBlockSession.swap_in`,
    `engine.incremental.run_incremental`) and the push-routing estimate
    (`serving.server`) all need "the vertices whose update equations a
    state/graph change can invalidate", which is the change's support plus
    its out-neighbors — previously re-derived ad hoc at each site.

    ``seeds`` is either a ``bool[n]`` mask or an integer id array;
    ``depth=0`` returns just the seed set as a mask. Vectorized: each hop is
    one boolean gather/scatter over the edge arrays.
    """
    mask = np.zeros(n, bool)
    seeds = np.asarray(seeds)
    if seeds.dtype == bool:
        if seeds.shape != (n,):
            raise ValueError(f"bool seed mask must be (n,) = ({n},), "
                             f"got {seeds.shape}")
        mask |= seeds
    elif len(seeds):
        mask[seeds.astype(np.int64)] = True
    src = np.asarray(src)
    dst = np.asarray(dst)
    for _ in range(depth):
        mask[dst[mask[src]]] = True
    return mask


@dataclasses.dataclass
class GraphDelta:
    """One batch of graph updates: ``apply`` produces the mutated graph.

    n_add        appended vertices (new ids ``g.n .. g.n + n_add - 1``)
    add_src/dst  inserted edges (may reference new vertices)
    add_w        optional weights for the inserted edges
    del_src/dst  deleted edges, addressed by endpoint pair
    rew_src/dst  reweighted existing edges …
    rew_w        … and their new weights
    """

    n_add: int = 0
    add_src: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I.copy())
    add_dst: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I.copy())
    add_w: Optional[np.ndarray] = None
    del_src: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I.copy())
    del_dst: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I.copy())
    rew_src: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I.copy())
    rew_dst: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I.copy())
    rew_w: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_F.copy())

    def __post_init__(self):
        self.add_src, self.add_dst = _as_edges(self.add_src, self.add_dst)
        self.del_src, self.del_dst = _as_edges(self.del_src, self.del_dst)
        self.rew_src, self.rew_dst = _as_edges(self.rew_src, self.rew_dst)
        if self.add_w is not None:
            self.add_w = np.asarray(self.add_w, np.float32).reshape(-1)
            if self.add_w.shape != self.add_src.shape:
                raise ValueError("add_w must match add_src/add_dst length")
        self.rew_w = np.asarray(self.rew_w, np.float32).reshape(-1)
        if self.rew_w.shape != self.rew_src.shape:
            raise ValueError("rew_w must match rew_src/rew_dst length")
        if self.n_add < 0:
            raise ValueError("n_add must be >= 0")

    @property
    def size(self) -> int:
        """Total number of edge updates in the batch."""
        return len(self.add_src) + len(self.del_src) + len(self.rew_src)

    def touched_vertices(
        self, g: Optional[Graph] = None, *, closure: int = 0
    ) -> np.ndarray:
        """Sorted unique endpoints of every mutated edge (new-id space) —
        the vertex set whose update equations this delta can directly
        invalidate. The serving layer's cache invalidation and frontier
        seeding both start from this set's blocks; appended vertices
        without edges are deliberately absent (nothing can have depended
        on them).

        ``closure > 0`` widens the set by that many out-edge hops of ``g``
        (the **post-apply** graph — the inserted edges must be walkable):
        the depth-1 set is every vertex a warm restart can perturb in its
        first round, which is what the push router sizes its frontier
        estimate with."""
        verts = np.unique(np.concatenate([
            self.add_src, self.add_dst, self.del_src, self.del_dst,
            self.rew_src, self.rew_dst,
        ]).astype(np.int64))
        if closure == 0:
            return verts
        if g is None:
            raise ValueError(
                "touched_vertices(closure > 0) walks out-edges and needs "
                "the post-apply graph: pass g = delta.apply(old_graph)"
            )
        mask = out_closure(g.src, g.dst, verts, g.n, depth=closure)
        return np.nonzero(mask)[0].astype(np.int64)

    def apply(self, g: Graph) -> Graph:
        """Return the mutated graph; ``g`` is left untouched."""
        n_new = g.n + self.n_add
        # out-of-range del/rew endpoints would alias a *different* edge
        # through the src*n+dst key arithmetic below, so reject them all
        for name, arr in (
            ("add", self.add_src), ("add", self.add_dst),
            ("del", self.del_src), ("del", self.del_dst),
            ("rew", self.rew_src), ("rew", self.rew_dst),
        ):
            if len(arr) and (arr.min() < 0 or arr.max() >= n_new):
                raise ValueError(f"{name} edge endpoint out of range for n={n_new}")
        src, dst = g.src, g.dst
        weighted = (g.w is not None) or (self.add_w is not None) or len(self.rew_w)
        w = g.weights.copy() if weighted else None

        if len(self.del_src):
            drop = _pair_member(src, dst, self.del_src, self.del_dst, n_new)
            keep = ~drop
            src, dst = src[keep], dst[keep]
            if w is not None:
                w = w[keep]

        if len(self.rew_src):
            if w is None:  # reweighting an unweighted graph materializes 1.0s
                w = np.ones(len(src), np.float32)
            key = src.astype(np.int64) * n_new + dst
            rkey = self.rew_src.astype(np.int64) * n_new + self.rew_dst
            order = np.argsort(rkey)
            pos = np.searchsorted(rkey[order], key)
            pos = np.clip(pos, 0, len(rkey) - 1)
            hit = rkey[order][pos] == key
            w = np.where(hit, self.rew_w[order][pos], w).astype(np.float32)

        if len(self.add_src):
            src = np.concatenate([src, self.add_src])
            dst = np.concatenate([dst, self.add_dst])
            if w is not None:
                aw = (self.add_w if self.add_w is not None
                      else np.ones(len(self.add_src), np.float32))
                w = np.concatenate([w, aw])

        return Graph(n_new, src, dst, w)


def _pair_member(
    src: np.ndarray, dst: np.ndarray, qsrc: np.ndarray, qdst: np.ndarray, n: int
) -> np.ndarray:
    """bool[m] — which (src, dst) edges appear in the (qsrc, qdst) set."""
    key = src.astype(np.int64) * n + dst
    qkey = np.unique(qsrc.astype(np.int64) * n + qdst)
    return np.isin(key, qkey)


def random_delta(
    g: Graph,
    *,
    frac_add: float = 0.01,
    frac_del: float = 0.0,
    frac_rew: float = 0.0,
    n_add_vertices: int = 0,
    w_lo: float = 1.0,
    w_hi: float = 10.0,
    seed: int = 0,
) -> GraphDelta:
    """Random delta batch sized as fractions of ``g.m`` (benchmarks/tests).

    Inserted edges draw uniform endpoints (self-loops and duplicates of
    existing edges are re-rolled); deletions and reweights sample existing
    edges without replacement. When ``g`` is weighted, inserted/reweighted
    edges draw uniform weights from ``[w_lo, w_hi)``; unweighted graphs get
    weightless insertions so they stay unweighted.
    """
    rng = np.random.default_rng(seed)
    n_new = g.n + n_add_vertices
    n_ins = int(round(g.m * frac_add))
    n_del = min(int(round(g.m * frac_del)), g.m)
    n_rew = min(int(round(g.m * frac_rew)), g.m)

    existing = set((g.src.astype(np.int64) * n_new + g.dst).tolist())
    add_src, add_dst = [], []
    # new vertices always get at least one incident edge so they join the graph
    for v in range(g.n, n_new):
        u = int(rng.integers(g.n))
        if rng.random() < 0.5:
            add_src.append(v), add_dst.append(u)
            existing.add(v * n_new + u)
        else:
            add_src.append(u), add_dst.append(v)
            existing.add(u * n_new + v)
    attempts = 0
    while len(add_src) < n_ins + n_add_vertices and attempts < 50 * (n_ins + 1):
        attempts += 1
        u = int(rng.integers(n_new))
        v = int(rng.integers(n_new))
        if u == v or (u * n_new + v) in existing:
            continue
        existing.add(u * n_new + v)
        add_src.append(u), add_dst.append(v)

    if n_del:
        pick = rng.choice(g.m, size=n_del, replace=False)
        del_src, del_dst = g.src[pick], g.dst[pick]
    else:
        del_src = del_dst = _EMPTY_I
    # don't reweight edges that are being deleted
    if n_rew:
        avoid = set((del_src.astype(np.int64) * n_new + del_dst).tolist())
        cand = rng.permutation(g.m)
        keep = [e for e in cand
                if (int(g.src[e]) * n_new + int(g.dst[e])) not in avoid][:n_rew]
        rew_src, rew_dst = g.src[keep], g.dst[keep]
        rew_w = rng.uniform(w_lo, w_hi, size=len(keep)).astype(np.float32)
    else:
        rew_src = rew_dst = _EMPTY_I
        rew_w = _EMPTY_F

    weighted = g.w is not None
    return GraphDelta(
        n_add=n_add_vertices,
        add_src=np.asarray(add_src, np.int32),
        add_dst=np.asarray(add_dst, np.int32),
        add_w=(rng.uniform(w_lo, w_hi, size=len(add_src)).astype(np.float32)
               if weighted else None),
        del_src=del_src, del_dst=del_dst,
        rew_src=rew_src, rew_dst=rew_dst, rew_w=rew_w,
    )
