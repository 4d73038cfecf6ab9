"""The general traffic generator: a mix is a data file under
``gpubench/traffic/<mix>.json`` that names its driver (a module under
``gpubench/drivers/``) and its parameters. This module turns the
parameters and the run's seed into the queries a run submits.

``"sources": "permutation"`` draws every vertex once, in an order that the
seed decides: no query repeats within a run, so a result cache never
answers, and every seed sends the same set of queries in another order.

A mix whose graph changes adds ``"deltas"``; `delta_batches` turns it and
the run's seed into the batches of edge changes the run applies.
"""
from __future__ import annotations

import numpy as np


def query_sources(n: int, mix: dict, seed: int) -> np.ndarray:
    """The vertices the run's queries start from, in submission order."""
    kind = mix["sources"]
    rng = np.random.default_rng([int(seed), 0x71756572])
    if kind == "permutation":
        return rng.permutation(n)
    raise ValueError(f"unknown sources {kind!r}")


def delta_batches(g, spec: dict, seed: int):
    """Batches of edge changes for `gpubench.graphs.apply_delta`, one at a
    time and without end, each drawn against the graph that the batches
    before it left (this generator applies each batch to its own copy).

    A batch inserts ``spec["insert"]`` links absent from the graph, with
    sources uniform, destinations drawn in proportion to in-degree + 1 (a
    new trust link goes to whom many trust already) and weight 1; and
    deletes ``spec["delete"]`` links drawn uniformly from the present ones.
    The draws come from the run's seed under a stream key of their own."""
    from gpubench.graphs import apply_delta

    rng = np.random.default_rng([int(seed), 0x64656c74])
    n_ins, n_del = int(spec["insert"]), int(spec["delete"])
    while True:
        n = g.n
        p = np.bincount(g.dst, minlength=n) + 1.0
        p /= p.sum()
        present = np.sort(g.src * n + g.dst)
        keys = np.empty(0, np.int64)
        while len(keys) < n_ins:
            want = 2 * (n_ins - len(keys)) + 8
            cand = rng.integers(n, size=want) * n + rng.choice(n, size=want, p=p)
            cand = cand[cand // n != cand % n]
            pos = np.minimum(np.searchsorted(present, cand), len(present) - 1)
            cand = np.concatenate([keys, cand[present[pos] != cand]])
            _, first = np.unique(cand, return_index=True)
            keys = cand[np.sort(first)][:n_ins]
        gone = rng.choice(g.m, size=n_del, replace=False)
        batch = {"add_src": keys // n, "add_dst": keys % n,
                 "add_w": np.ones(n_ins, np.float32),
                 "del_src": g.src[gone], "del_dst": g.dst[gone]}
        yield batch
        g = apply_delta(g, batch)


class Reservoir:
    """A uniform sample of ``size`` items from a stream, drawn from a seed
    (Algorithm R): which answers the check compares."""

    def __init__(self, size: int, seed: int) -> None:
        self.size = size
        self.items: list = []
        self.seen = 0
        self._rng = np.random.default_rng([int(seed), 0x73616d70])

    def offer(self, make) -> bool:
        """Keep the item ``make()`` builds with the right chance (``make``
        runs only then); True if it was kept (an item it replaced is gone)."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
            return True
        j = int(self._rng.integers(self.seen))
        if j < self.size:
            self.items[j] = make()
            return True
        return False
