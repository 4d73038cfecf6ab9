"""The paper's metric function M(.) and related order-quality measures (port
of ``repro.core.metric``; the incremental ``MetricTracker`` is not ported
yet).

M(O_V) = #{(u,v) in E : p(u) < p(v)}   (Eq. 7) — the number of *positive*
edges, whose destination sees the source's state from the current round.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.graph import Graph


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
