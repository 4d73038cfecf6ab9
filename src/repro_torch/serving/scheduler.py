"""Admission scheduling for the serving loop: families, queues, policies
(port of ``repro.serving.scheduler``, pure Python).

Queries can only share a resident state matrix when they share *structure* —
edge arrays, semiring, combine, residual, eps — i.e. when they differ only
in the per-column vertex arrays (``x0``/``c``/``fixed``). :func:`family_key`
classifies a submission without building the instance: each algorithm names
the constructor parameters that only shape columns (`COLUMN_PARAMS` — e.g.
SSSP's ``source``, PPR's ``seeds``); everything else is structural and keys
the family. The server double-checks the classification against the built
instances at swap-in time, so a wrong table entry fails loudly instead of
silently mixing incompatible queries.

Three admission policies order each family's queue (PriorityGraph-style
ordered scheduling at query granularity):

* ``fifo``      — arrival order.
* ``priority``  — higher ``priority`` first; FIFO among equals.
* ``deadline``  — earliest absolute deadline first (EDF; ``deadline`` is
  seconds after submit, ``None`` sorts last); priority, then FIFO, break
  ties.
"""
from __future__ import annotations

import heapq
import math
from typing import TYPE_CHECKING, Any, Optional

import numpy as np

if TYPE_CHECKING:  # server imports this module; type-only edge back
    from repro_torch.serving.server import Ticket

POLICIES = ("fifo", "priority", "deadline")

# constructor kwargs that only shape per-column vertex arrays (x0/c/fixed);
# everything else (weights transforms, eps, damping, ...) is structural.
COLUMN_PARAMS = {
    "pagerank": (),
    "katz": (),
    "cc": (),
    "php": ("target",),
    "adsorption": ("seeds", "p_inj"),
    "sssp": ("source",),
    "bfs": ("source",),
    "sswp": ("source",),
    "reachability": ("source",),
    "ppr": ("seeds",),
    "ms_sssp": ("sources",),
}


def canon(value: Any) -> Any:
    """Canonicalize a parameter value into a hashable key component."""
    if isinstance(value, dict):
        return tuple(sorted((k, canon(v)) for k, v in value.items()))
    if isinstance(value, np.ndarray):
        return tuple(canon(v) for v in value.tolist())
    if isinstance(value, (list, tuple, range)):
        return tuple(canon(v) for v in value)
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    return value


def family_key(algo: str, params: dict) -> tuple:
    """(algo, sorted structural params) — the unit that shares one resident
    state matrix. Unknown algorithms treat *all* params as structural (no
    sharing across differing params — always sound, just less packed)."""
    column = COLUMN_PARAMS.get(algo, None)
    items = [
        (k, canon(v)) for k, v in sorted(params.items())
        if column is None or k not in column
    ]
    return (algo, tuple(items))


class Scheduler:
    """Per-family admission queues under one policy.

    Tickets enter with :meth:`push` and leave with :meth:`pop` when the
    server has a free column in that family's resident matrix. Order within
    a family follows the policy; across families the server round-robins,
    so one hot family cannot starve another's resident slots.
    """

    def __init__(self, policy: str = "fifo") -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.policy = policy
        self._queues: dict[tuple, list] = {}

    def _key(self, ticket: "Ticket") -> tuple:
        # every key ends in the unique ticket id: deterministic FIFO
        # tie-breaking, and heap entries never fall through to comparing
        # Ticket objects
        if self.policy == "fifo":
            return (ticket.id,)
        if self.policy == "priority":
            return (-ticket.priority, ticket.id)
        edf = (
            ticket.submitted_at + ticket.deadline
            if ticket.deadline is not None else math.inf
        )
        return (edf, -ticket.priority, ticket.id)

    def push(self, ticket: "Ticket") -> None:
        q = self._queues.setdefault(ticket.family, [])
        heapq.heappush(q, (self._key(ticket), ticket))

    def pop(self, family: tuple) -> Optional["Ticket"]:
        """Next ticket for ``family`` per policy, or None."""
        q = self._queues.get(family)
        if not q:
            return None
        return heapq.heappop(q)[1]

    def peek(self, family: tuple) -> Optional["Ticket"]:
        """The ticket :meth:`pop` would return, without removing it."""
        q = self._queues.get(family)
        return q[0][1] if q else None

    def pending(self, family: tuple) -> int:
        return len(self._queues.get(family, ()))

    def total_pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def families(self) -> list[tuple]:
        """Family keys with at least one queued ticket (insertion order)."""
        return [k for k, q in self._queues.items() if q]
