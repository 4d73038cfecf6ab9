"""Directed-graph container used by the whole framework.

Everything is plain numpy on the host: graph *preprocessing* (GoGraph, the
baseline reorderers, partitioning, block packing) is host-side work; only the
iterative *compute* runs under PyTorch. The container keeps an edge list as the
source of truth and lazily materializes CSR (out-edges) / CSC (in-edges).

Vertex ids are dense ints [0, n). Edge weights are optional float32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """A directed graph with `n` vertices and edges (src[i] -> dst[i])."""

    n: int
    src: np.ndarray  # int32[m]
    dst: np.ndarray  # int32[m]
    w: Optional[np.ndarray] = None  # float32[m] or None (unweighted)

    # lazy adjacency caches
    _csr: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _csc: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        if self.w is not None:
            self.w = np.asarray(self.w, dtype=np.float32)
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")
        if self.m and (self.src.min() < 0 or self.src.max() >= self.n):
            raise ValueError("src ids out of range")
        if self.m and (self.dst.min() < 0 or self.dst.max() >= self.n):
            raise ValueError("dst ids out of range")

    # ------------------------------------------------------------------ basic
    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def weights(self) -> np.ndarray:
        if self.w is None:
            return np.ones(self.m, dtype=np.float32)
        return self.w

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n).astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n).astype(np.int64)

    def degrees(self) -> np.ndarray:
        return self.out_degrees() + self.in_degrees()

    # ------------------------------------------------------------- adjacency
    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Out-adjacency: (indptr[n+1], indices[m]=dst sorted by src, eid[m])."""
        if self._csr is None:
            order = np.argsort(self.src, kind="stable")
            indptr = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(np.bincount(self.src, minlength=self.n), out=indptr[1:])
            self._csr = (indptr, self.dst[order], order.astype(np.int64))
        return self._csr

    def csc(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """In-adjacency: (indptr[n+1], indices[m]=src sorted by dst, eid[m])."""
        if self._csc is None:
            order = np.argsort(self.dst, kind="stable")
            indptr = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(np.bincount(self.dst, minlength=self.n), out=indptr[1:])
            self._csc = (indptr, self.src[order], order.astype(np.int64))
        return self._csc

    def out_neighbors(self, v: int) -> np.ndarray:
        indptr, idx, _ = self.csr()
        return idx[indptr[v]:indptr[v + 1]]

    def in_neighbors(self, v: int) -> np.ndarray:
        indptr, idx, _ = self.csc()
        return idx[indptr[v]:indptr[v + 1]]

    # ------------------------------------------------------------ transforms
    def relabel(self, rank: np.ndarray) -> "Graph":
        """Relabel vertices so vertex v gets id rank[v] (its ordinal number).

        After relabeling, processing vertices 0..n-1 in id order realizes the
        processing order encoded by `rank`.
        """
        rank = np.asarray(rank)
        if rank.shape != (self.n,):
            raise ValueError("rank must have shape (n,)")
        check_permutation(rank, self.n)
        w = None if self.w is None else self.w.copy()
        return Graph(self.n, rank[self.src], rank[self.dst], w)

    def subgraph(self, vertices: np.ndarray) -> tuple["Graph", np.ndarray]:
        """Induced subgraph. Returns (sub, mapping old_id array of len n_sub)."""
        vertices = np.asarray(vertices, dtype=np.int32)
        mask = np.zeros(self.n, dtype=bool)
        mask[vertices] = True
        keep = mask[self.src] & mask[self.dst]
        new_id = -np.ones(self.n, dtype=np.int32)
        new_id[vertices] = np.arange(len(vertices), dtype=np.int32)
        w = None if self.w is None else self.w[keep]
        sub = Graph(len(vertices), new_id[self.src[keep]], new_id[self.dst[keep]], w)
        return sub, vertices

    def reverse(self) -> "Graph":
        w = None if self.w is None else self.w.copy()
        return Graph(self.n, self.dst.copy(), self.src.copy(), w)

    def undirected_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Symmetrized, deduped edge endpoints (for community detection)."""
        a = np.minimum(self.src, self.dst)
        b = np.maximum(self.src, self.dst)
        key = a.astype(np.int64) * self.n + b
        _, first = np.unique(key, return_index=True)
        return a[first], b[first]

    def __repr__(self) -> str:  # compact: the dataclass repr would dump arrays
        return f"Graph(n={self.n}, m={self.m}, weighted={self.w is not None})"


def check_permutation(rank: np.ndarray, n: int) -> None:
    seen = np.zeros(n, dtype=bool)
    seen[rank] = True
    if not seen.all():
        raise ValueError("rank is not a permutation of 0..n-1")


def order_to_rank(order: np.ndarray) -> np.ndarray:
    """order[i] = vertex processed i-th  ->  rank[v] = position of v."""
    order = np.asarray(order)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order), dtype=order.dtype)
    return rank


def rank_to_order(rank: np.ndarray) -> np.ndarray:
    return order_to_rank(rank)  # involution
