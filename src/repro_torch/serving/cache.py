"""Byte-budgeted LRU result cache with graph-version region invalidation
(port of ``repro.serving.cache``, pure Python).

Entries are keyed by ``(tenant, algo, canonical params)`` and carry the
``graph_version`` they were computed at; a lookup hits only when the entry's
version matches the owning tenant's current one. The point of the design is
what happens when a :class:`~repro_torch.graphs.delta.GraphDelta` lands: instead
of flushing everything, :meth:`ResultCache.apply_delta` *promotes* to the
new version every entry whose cached **support blocks** miss the
delta-touched blocks, and drops the rest.

Why that rule is sound (and not just a heuristic): an entry's support is the
block set where its answer or its inputs deviate from the workload's inert
fill (`engine.harness.column_support` with the finished state folded in —
reached vertices, seeds, pinned targets). A delta edge can only change the
query's fixpoint by injecting or removing influence along a path from the
query's inputs; the *first* delta edge on any such path leaves a supported
vertex, so its endpoint block intersects the support and the entry is
dropped. Mutations entirely among unsupported (inert-valued) vertices
contribute the semiring's absorbing fill exactly as before and cannot move
any supported value. Appended vertices that survive promotion are
unreachable from the entry's inputs by the same argument, so the promoted
state extends with the workload's inert fill. Global-support workloads
(pagerank: ``c > 0`` everywhere) have every block in their support and are
invalidated by any edge delta — the correct, conservative outcome.

Block granularity matches the serving engine's ``bs``: coarser than vertex
granularity, so strictly more conservative, never less sound.

Two bounds keep a long-running multi-tenant server honest:

* ``max_bytes`` — a byte budget over the cached ``(n,)`` states. The cache
  is an LRU (ordered dict, recency = get/put): inserting past the budget
  evicts least-recently-used entries until it fits; an entry larger than
  the whole budget is simply not retained.
* Per-tenant invalidation — :meth:`apply_delta` takes a ``select``
  predicate over keys, so one tenant's graph delta can never touch another
  tenant's entries (their versions advance independently).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Iterable, Optional

import numpy as np


@dataclasses.dataclass
class CacheEntry:
    x: np.ndarray               # finished (n,) state of the query
    rounds: int                 # rounds the computing run took
    support_blocks: frozenset   # block ids the answer/inputs touch
    graph_version: int
    x0_fill: float              # inert fill — extends x when n grows
    hits: int = 0


# accounting overhead charged per entry on top of the state bytes (key
# tuple, support set, dataclass) — keeps a budget of tiny states from
# admitting an unbounded entry count
_ENTRY_OVERHEAD = 256


def _entry_bytes(e: CacheEntry) -> int:
    return int(e.x.nbytes) + _ENTRY_OVERHEAD


class ResultCache:
    """(tenant, algo, params)-keyed LRU results, region-invalidated.

    ``max_bytes`` bounds the resident bytes (None = unbounded, the pre-LRU
    behavior). Recency order: :meth:`get` hits and :meth:`put` inserts both
    refresh an entry; eviction pops the least recently used.
    """

    def __init__(self, max_bytes: Optional[int] = None) -> None:
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        self.max_bytes = max_bytes
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.invalidated = 0
        self.promoted = 0
        self.evicted = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple, graph_version: int) -> Optional[CacheEntry]:
        """The cached entry for ``key`` at ``graph_version``, else None."""
        e = self._entries.get(key)
        if e is None or e.graph_version != graph_version:
            self.misses += 1
            return None
        self._entries.move_to_end(key)  # LRU refresh
        self.hits += 1
        e.hits += 1
        return e

    def put(
        self, key: tuple, x: np.ndarray, rounds: int,
        support_blocks: Iterable[int], graph_version: int, x0_fill: float,
    ) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= _entry_bytes(old)
        e = CacheEntry(
            x=np.asarray(x).copy(), rounds=int(rounds),
            support_blocks=frozenset(int(b) for b in support_blocks),
            graph_version=graph_version, x0_fill=float(x0_fill),
        )
        self._entries[key] = e
        self.bytes += _entry_bytes(e)
        self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        if self.max_bytes is None:
            return
        while self.bytes > self.max_bytes and self._entries:
            _, old = self._entries.popitem(last=False)  # least recently used
            self.bytes -= _entry_bytes(old)
            self.evicted += 1

    def apply_delta(
        self, touched_blocks: Iterable[int], new_version: int,
        n_new: int | None = None,
        select: Optional[Callable[[tuple], bool]] = None,
    ) -> None:
        """Promote entries untouched by the delta; drop the rest.

        ``touched_blocks`` — block ids containing any endpoint of a
        mutated (added/deleted/reweighted) edge. ``n_new`` extends promoted
        states with their inert fill when the delta appended vertices.
        ``select`` scopes the pass to one tenant's keys — unselected
        entries are left untouched (their tenant's version didn't move).
        """
        touched = frozenset(int(b) for b in touched_blocks)
        for key in list(self._entries):
            if select is not None and not select(key):
                continue
            e = self._entries[key]
            if e.graph_version != new_version - 1 or (e.support_blocks & touched):
                del self._entries[key]
                self.bytes -= _entry_bytes(e)
                self.invalidated += 1
                continue
            e.graph_version = new_version
            if n_new is not None and n_new > len(e.x):
                self.bytes -= _entry_bytes(e)
                e.x = np.concatenate([
                    e.x,
                    np.full(n_new - len(e.x), e.x0_fill, e.x.dtype),
                ])
                self.bytes += _entry_bytes(e)
            self.promoted += 1
        self._evict_to_budget()  # promotion growth can overshoot the budget

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "invalidated": self.invalidated,
            "promoted": self.promoted,
            "evicted": self.evicted,
        }
