"""The paper's metric function M(.) and related order-quality measures (port
of ``repro.core.metric``).

M(O_V) = #{(u,v) in E : p(u) < p(v)}   (Eq. 7) — the number of *positive*
edges, whose destination sees the source's state from the current round.

:class:`MetricTracker` maintains M (and per-region M) incrementally as
:class:`~repro_torch.graphs.delta.GraphDelta` batches mutate the graph —
O(|delta|) per batch instead of the O(m) `metric_m` recompute — which is
what lets the serving layer watch the order decay and trigger regional
re-ranks online.
"""
from __future__ import annotations

from collections import Counter
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.graphs.graph import Graph, check_permutation, rank_to_order

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (delta imports graph)
    from repro_torch.graphs.delta import GraphDelta


def metric_m(g: Graph, rank: np.ndarray) -> int:
    """Count positive edges of order `rank` (rank[v] = ordinal p(v))."""
    rank = np.asarray(rank)
    return int(np.count_nonzero(rank[g.src] < rank[g.dst]))


def positive_edge_fraction(g: Graph, rank: np.ndarray) -> float:
    """M / |E| — the normalized column of paper Table II."""
    return metric_m(g, rank) / max(1, g.m)


def metric_m_torch(src: torch.Tensor, dst: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """M on tensors (any device), counted in int64: a 0-d tensor."""
    return torch.sum(rank[src.long()] < rank[dst.long()], dtype=torch.int64)


def _pair_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Endpoint-pair keys (ids are int32, so ``s << 32 | d`` never collides).

    Stable under vertex appends — unlike the ``src * n + dst`` arithmetic in
    `GraphDelta.apply`, which re-keys every delta — so the tracker's edge
    multiset survives graph growth without rebuilding."""
    return (np.asarray(src).astype(np.int64) << 32) | np.asarray(dst).astype(np.int64)


class MetricTracker:
    """Incremental maintenance of M under `GraphDelta` mutations.

    Holds the graph's edge multiset (keyed by endpoint pair), the current
    rank, and per-region positive/total edge counts, where a vertex's
    *region* is the ``regions``-way contiguous span of rank positions it
    occupied at the last (re)base — the unit at which the serving layer
    triggers regional re-ranks. ``apply_delta`` is O(|delta|) edge work:

    * insertions/deletions adjust the multiset and the counts using the
      current rank (deletions remove every copy of a pair, mirroring
      ``GraphDelta.apply``);
    * reweights never change M;
    * appended vertices require the extended rank (``extend_rank`` output —
      any update that *preserves the relative order* of tracked vertices is
      exact, because old edges' positivity only depends on relative order).
      New vertices inherit the region of their predecessor in the new order.

    After an arbitrary reorder (e.g. `regional_rerank`) relative order is
    *not* preserved — call :meth:`rebase` with the new rank instead.

    ``tracker.M == metric_m(g_current, rank_current)`` holds exactly at
    every step (held against the reference's tracker in
    tests/test_torch_metrics.py).
    """

    def __init__(self, g: Graph, rank: np.ndarray, *, regions: int = 16) -> None:
        if regions < 1:
            raise ValueError(f"regions must be >= 1, got {regions}")
        self.regions = int(regions)
        self._base(g, rank)

    def _base(self, g: Graph, rank: np.ndarray) -> None:
        rank = np.asarray(rank, dtype=np.int64)
        if rank.shape != (g.n,):
            raise ValueError(f"rank must have shape ({g.n},), got {rank.shape}")
        check_permutation(rank, g.n)
        self.n = g.n
        self._rank = rank.copy()
        # region = contiguous span of rank positions, frozen at (re)base time
        self._region_of = (rank * self.regions) // max(1, g.n)
        uk, cnt = np.unique(_pair_keys(g.src, g.dst), return_counts=True)
        self._edges: Counter[int] = Counter(dict(zip(uk.tolist(), cnt.tolist())))
        self.m_edges = g.m
        pos = rank[g.src] < rank[g.dst]
        self.M = int(np.count_nonzero(pos))
        reg = self._region_of[g.dst]
        self.region_m = np.bincount(reg[pos], minlength=self.regions).astype(np.int64)
        self.region_edges = np.bincount(reg, minlength=self.regions).astype(np.int64)
        self.baseline_fraction = self.fractions()

    def rebase(self, g: Graph, rank: np.ndarray, *, regions: Optional[int] = None) -> None:
        """Full O(m) recount against a new rank (after an arbitrary reorder)."""
        if regions is not None:
            if regions < 1:
                raise ValueError(f"regions must be >= 1, got {regions}")
            self.regions = int(regions)
        self._base(g, rank)

    # -- queries -----------------------------------------------------------
    @property
    def rank(self) -> np.ndarray:
        return self._rank

    @property
    def region_of(self) -> np.ndarray:
        return self._region_of

    @property
    def m_frac(self) -> float:
        """M / |E| — the tracked `positive_edge_fraction`."""
        return self.M / max(1, self.m_edges)

    def fractions(self) -> np.ndarray:
        """Per-region M fraction; empty regions report 1.0 (nothing to decay)."""
        frac = self.region_m / np.maximum(self.region_edges, 1)
        return np.where(self.region_edges > 0, frac, 1.0)

    def decayed_regions(self, threshold: float, *, min_edges: int = 8) -> np.ndarray:
        """Regions whose M fraction fell below ``threshold`` *and* below their
        fraction at the last (re)base — the regional re-rank trigger set.
        Regions with fewer than ``min_edges`` edges never trigger (a handful
        of inverted edges is not worth a re-rank)."""
        frac = self.fractions()
        hit = (self.region_edges >= min_edges) & (frac < threshold)
        hit &= frac < self.baseline_fraction
        return np.nonzero(hit)[0].astype(np.int64)

    def region_members(self, region_ids: np.ndarray) -> np.ndarray:
        """Vertex ids assigned to the given regions (at the last rebase)."""
        return np.nonzero(np.isin(self._region_of, region_ids))[0].astype(np.int64)

    # -- the O(|delta|) update ---------------------------------------------
    def apply_delta(self, delta: "GraphDelta", rank_new: Optional[np.ndarray] = None) -> None:
        """Fold one `GraphDelta` into the tracked counts.

        Mirrors ``GraphDelta.apply`` semantics (deletions first, addressed by
        endpoint pair and removing every copy; reweights are M-neutral; then
        insertions). When ``delta.n_add > 0`` the extended rank over all
        ``n + n_add`` vertices is required and must preserve the relative
        order of the existing vertices (``extend_rank`` guarantees this)."""
        if delta.n_add:
            if rank_new is None:
                raise ValueError(
                    "apply_delta: delta appends vertices; pass the extended "
                    "rank (extend_rank output) as rank_new"
                )
            self._extend(np.asarray(rank_new, dtype=np.int64), delta.n_add)
        if len(delta.del_src):
            dk = _pair_keys(delta.del_src, delta.del_dst)
            _, first = np.unique(dk, return_index=True)
            s = delta.del_src[first].astype(np.int64)
            d = delta.del_dst[first].astype(np.int64)
            counts = np.fromiter(
                (self._edges.pop(int(k), 0) for k in dk[first]),
                dtype=np.int64, count=len(first),
            )
            pos = self._rank[s] < self._rank[d]
            reg = self._region_of[d]
            self.m_edges -= int(counts.sum())
            self.M -= int(counts[pos].sum())
            np.subtract.at(self.region_edges, reg, counts)
            np.subtract.at(self.region_m, reg, counts * pos)
        if len(delta.add_src):
            s = delta.add_src.astype(np.int64)
            d = delta.add_dst.astype(np.int64)
            for k in _pair_keys(s, d).tolist():
                self._edges[k] += 1
            pos = self._rank[s] < self._rank[d]
            reg = self._region_of[d]
            self.m_edges += len(s)
            self.M += int(np.count_nonzero(pos))
            np.add.at(self.region_edges, reg, 1)
            np.add.at(self.region_m, reg, pos.astype(np.int64))

    def _extend(self, rank_new: np.ndarray, n_add: int) -> None:
        n_new = self.n + n_add
        if rank_new.shape != (n_new,):
            raise ValueError(
                f"rank_new must cover all {n_new} vertices, got {rank_new.shape}"
            )
        check_permutation(rank_new, n_new)
        # region forward-fill: a new vertex inherits the region of the nearest
        # *old* vertex preceding it in the new order (head-of-order -> region 0)
        order = rank_to_order(rank_new)
        if self.n == 0:
            self._region_of = np.zeros(n_new, dtype=np.int64)
        else:
            old_pos = np.where(order < self.n, np.arange(n_new), -1)
            last_old = np.maximum.accumulate(old_pos)
            # gather ids are old vertices wherever last_old >= 0; the clip only
            # sanitizes lanes the where() masks out (a new vertex ranked first)
            gather = np.minimum(order[np.maximum(last_old, 0)], self.n - 1)
            reg_by_pos = np.where(last_old >= 0, self._region_of[gather], 0)
            region_new = np.empty(n_new, dtype=np.int64)
            region_new[order] = reg_by_pos
            self._region_of = region_new
        self._rank = rank_new.copy()
        self.n = n_new


def edge_span(g: Graph, rank: np.ndarray) -> float:
    """Mean |p(u) - p(v)| over edges.

    Locality proxy: small spans mean a vertex and its neighbors are close in
    the processing order, the property the paper links to CPU cache hits
    (§IV-A "Divide other vertices") and that in the block sweep controls how many distinct
    state tiles a block update touches.
    """
    rank = np.asarray(rank, dtype=np.int64)
    if g.m == 0:
        return 0.0
    return float(np.abs(rank[g.src] - rank[g.dst]).mean())


def block_fresh_fraction(g: Graph, rank: np.ndarray, bs: int) -> dict:
    """Edge freshness at block granularity: an edge delivers a current-round
    state iff its source's block precedes its destination's block."""
    rank = np.asarray(rank, dtype=np.int64)
    sb = rank[g.src] // bs
    db = rank[g.dst] // bs
    m = max(1, g.m)
    return {
        "fresh": float(np.count_nonzero(sb < db) / m),
        "intra": float(np.count_nonzero(sb == db) / m),
        "stale": float(np.count_nonzero(sb > db) / m),
    }


def metric_table(g: Graph, ranks: dict[str, np.ndarray], bs: int = 256) -> dict[str, dict]:
    """Convenience: per-order quality summary (Table II style)."""
    out = {}
    for name, rank in ranks.items():
        m_val = metric_m(g, rank)
        row = {
            "M": m_val,
            "M_over_E": m_val / max(1, g.m),
            "edge_span": edge_span(g, rank),
        }
        row.update({f"block_{k}": v for k, v in block_fresh_fraction(g, rank, bs).items()})
        out[name] = row
    return out
